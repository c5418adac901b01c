"""Import hygiene of the port: ``sitewhere_tpu_torch`` and ``chip_smoke.py``
import in a subprocess where importing ``jax``, ``flax``, ``optax`` or
anything of ``sitewhere_tpu`` RAISES — the port runs on machines that have
none of them. Only the parity tests import both packages."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_DRIVER = r"""
import importlib
import importlib.util
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import sitewhere_tpu_torch

names = ["sitewhere_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(sitewhere_tpu_torch.__path__,
                                          "sitewhere_tpu_torch.")]
failures = []
for name in names:
    try:
        importlib.import_module(name)
    except BaseException as e:
        failures.append(f"{name}: {type(e).__name__}: {e}")
try:
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
except BaseException as e:
    failures.append(f"chip_smoke.py: {type(e).__name__}: {e}")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
if leaked:
    failures.append(f"blocked modules present: {leaked}")
print(len(names))
print(" ".join(names))
print("\n".join(failures))
sys.exit(1 if failures else 0)
"""


def test_port_and_chip_smoke_import_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _DRIVER, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, (
        f"the port grew a JAX import:\n{res.stdout}\n{res.stderr}")
    # every module was walked: the wire-ingest and durability modules, the
    # archive, the outbound feed, the analytics jobs and the parallel
    # package too
    count, names = res.stdout.splitlines()[:2]
    assert int(count) >= 50
    assert {"sitewhere_tpu_torch.utils.archive", "sitewhere_tpu_torch.outbound.feed",
            "sitewhere_tpu_torch.ops.window_fill",
            "sitewhere_tpu_torch.models.analytics",
            # the host plane
            "sitewhere_tpu_torch.utils.metrics", "sitewhere_tpu_torch.utils.tracing",
            "sitewhere_tpu_torch.utils.flight", "sitewhere_tpu_torch.utils.qos",
            "sitewhere_tpu_torch.utils.autotune", "sitewhere_tpu_torch.utils.devicewatch",
            "sitewhere_tpu_torch.utils.conservation", "sitewhere_tpu_torch.ingest.workers",
            "sitewhere_tpu_torch.loadgen",
            # sequence parallelism
            "sitewhere_tpu_torch.parallel", "sitewhere_tpu_torch.parallel.ring_attention",
            # the multi-shard engines and what they stand on
            "sitewhere_tpu_torch.parallel.mesh", "sitewhere_tpu_torch.parallel.router",
            "sitewhere_tpu_torch.parallel.exchange", "sitewhere_tpu_torch.parallel.sharded",
            "sitewhere_tpu_torch.parallel.multihost",
            "sitewhere_tpu_torch.parallel.placement", "sitewhere_tpu_torch.utils.shardobs",
            # the mesh product engine and the offline reshard
            "sitewhere_tpu_torch.parallel.distributed",
            "sitewhere_tpu_torch.parallel.reshard",
            # the two-process job, the event sources and the leaves under them
            "sitewhere_tpu_torch.parallel.multihost_demo",
            "sitewhere_tpu_torch.ingest.sources", "sitewhere_tpu_torch.ingest.dedup",
            "sitewhere_tpu_torch.utils.lifecycle", "sitewhere_tpu_torch.utils.scripting",
            "sitewhere_tpu_torch.utils.faults", "sitewhere_tpu_torch.native.route_fallback",
            # the wire edge, the broker receivers and the load generator's wire legs
            "sitewhere_tpu_torch.ingest.mqtt", "sitewhere_tpu_torch.ingest.wire_edge",
            "sitewhere_tpu_torch.ingest.coap", "sitewhere_tpu_torch.ingest.amqp",
            "sitewhere_tpu_torch.ingest.stomp", "sitewhere_tpu_torch.ingest.eventhub",
            "sitewhere_tpu_torch.utils.streams",
            # the entity and outbound services
            "sitewhere_tpu_torch.management.entities",
            "sitewhere_tpu_torch.management.device_management",
            "sitewhere_tpu_torch.management.assets", "sitewhere_tpu_torch.management.batch",
            "sitewhere_tpu_torch.management.schedule",
            "sitewhere_tpu_torch.management.streams", "sitewhere_tpu_torch.commands.model",
            "sitewhere_tpu_torch.commands.encoders", "sitewhere_tpu_torch.commands.routing",
            "sitewhere_tpu_torch.commands.destinations",
            "sitewhere_tpu_torch.commands.service", "sitewhere_tpu_torch.connectors.base",
            "sitewhere_tpu_torch.connectors.impl", "sitewhere_tpu_torch.connectors.aws",
            "sitewhere_tpu_torch.connectors.multicast", "sitewhere_tpu_torch.search.index",
            "sitewhere_tpu_torch.labels.qrcode", "sitewhere_tpu_torch.labels.manager",
            "sitewhere_tpu_torch.outbound.zones",
            # the servers
            "sitewhere_tpu_torch.instance.auth", "sitewhere_tpu_torch.instance.tenants",
            "sitewhere_tpu_torch.instance.instance", "sitewhere_tpu_torch.config",
            "sitewhere_tpu_torch.rpc.protocol", "sitewhere_tpu_torch.rpc.client",
            "sitewhere_tpu_torch.rpc.server", "sitewhere_tpu_torch.web.http",
            "sitewhere_tpu_torch.web.rest", "sitewhere_tpu_torch.parallel.replication",
            # the cluster planes and the rules oracle
            *CLUSTER_MODULES,
            } <= set(names.split())


CLUSTER_MODULES = tuple(f"sitewhere_tpu_torch.{m}" for m in (
    "parallel.cluster", "parallel.forward", "parallel.placement",
    "parallel.replication", "parallel.entity_sync", "parallel.cluster_reshard",
    "parallel.rank_runtime", "parallel.cluster_demo", "rules.oracle"))


def _module_paths(root: pathlib.Path) -> set[str]:
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
            if "__pycache__" not in p.parts}


def test_every_jax_module_has_a_port_module():
    """The port is whole: each module path of ``sitewhere_tpu/`` has one of
    the same path under ``sitewhere_tpu_torch/`` (no exceptions)."""
    jax_paths = _module_paths(REPO / "sitewhere_tpu")
    missing = sorted(jax_paths - _module_paths(REPO / "sitewhere_tpu_torch"))
    assert len(jax_paths) > 100
    assert missing == []


_SERVERS_PROBE = r"""
import asyncio
import base64
import importlib
import json
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu", "aiohttp")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import sitewhere_tpu_torch

failures = []
for m in pkgutil.walk_packages(sitewhere_tpu_torch.__path__, "sitewhere_tpu_torch."):
    try:
        importlib.import_module(m.name)
    except BaseException as e:
        failures.append(f"{m.name}: {type(e).__name__}: {e}")

from sitewhere_tpu_torch.engine import EngineConfig
from sitewhere_tpu_torch.instance.instance import InstanceConfig, SiteWhereTpuInstance
from sitewhere_tpu_torch.rpc.client import RpcClient
from sitewhere_tpu_torch.rpc.server import build_instance_rpc, system_jwt
from sitewhere_tpu_torch.web import http
from sitewhere_tpu_torch.web.rest import start_server


async def main():
    inst = SiteWhereTpuInstance(InstanceConfig(engine=EngineConfig(
        device_capacity=64, token_capacity=128, assignment_capacity=128,
        store_capacity=1024, batch_capacity=16, channels=4)), device="cpu")
    server = await start_server(inst)
    rpc = build_instance_rpc(inst)
    rpc_port = await rpc.start()
    base = f"http://127.0.0.1:{server.port}"
    out = {}
    try:
        async with http.ClientSession() as s:
            basic = base64.b64encode(b"admin:password").decode()
            r = await s.get(base + "/api/authapi/jwt",
                            headers={"Authorization": f"Basic {basic}"})
            h = {"Authorization": f"Bearer {(await r.json())['token']}"}
            r = await s.post(base + "/api/devices", json={"token": "imp-1"}, headers=h)
            out["create"] = r.status
            r = await s.post(base + "/api/devices/imp-1/events", headers=h, json={
                "type": "DeviceMeasurement", "request": {"name": "t", "value": 2.5}})
            out["event"] = r.status
            r = await s.get(base + "/api/devices/imp-1/state", headers=h)
            out["value"] = (await r.json())["measurements"]["t"]["value"]
            r = await s.get(base + "/api/system/version", headers=h)
            out["backend"] = (await r.json())["backend"]
        cli = await RpcClient(port=rpc_port, auth_token=system_jwt(inst)).connect()
        out["rpc"] = (await cli.call("DeviceManagement.listDevices"))["numResults"]
        await cli.close()
    finally:
        await rpc.stop()
        await server.cleanup()
    return out


out = asyncio.run(main())
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
if leaked:
    failures.append(f"blocked modules present: {leaked}")
print(json.dumps(out))
print("\n".join(failures))
sys.exit(1 if failures else 0)
"""


def test_servers_serve_with_jax_and_aiohttp_blocked():
    """Every module imports, and a REST round trip (over the port's own
    HTTP client) and an RPC call run, where importing ``jax``, anything of
    ``sitewhere_tpu`` or ``aiohttp`` raises: the card machine has none."""
    res = subprocess.run([sys.executable, "-c", _SERVERS_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.splitlines()[0])
    assert out == {"create": 201, "event": 201, "value": 2.5, "backend": "cpu",
                   "rpc": 1}


_CLUSTER_PROBE = r"""
import asyncio
import importlib
import json
import sys
import tempfile
import threading
import time

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu", "aiohttp")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

for name in sys.argv[1:]:
    importlib.import_module(name)

# what a spawned demo worker imports, in its order
from sitewhere_tpu_torch.parallel.cluster_demo import worker_main  # noqa: F401
from sitewhere_tpu_torch.engine import EngineConfig  # noqa: F401
from sitewhere_tpu_torch.instance.instance import InstanceConfig  # noqa: F401
from sitewhere_tpu_torch.parallel.rank_runtime import RankConfig, run_rank  # noqa: F401

from sitewhere_tpu_torch.parallel.cluster import (ClusterConfig, ClusterEngine,
                                                  build_cluster_rpc, owner_rank)
from sitewhere_tpu_torch.parallel.cluster_demo import free_ports
from sitewhere_tpu_torch.parallel.distributed import DistributedConfig
from sitewhere_tpu_torch.parallel.forward import ForwardQueue, SpillRegistry

ports = free_ports(2)
loop = asyncio.new_event_loop()
threading.Thread(target=loop.run_forever, daemon=True).start()
tmp = tempfile.mkdtemp()
peers = [f"127.0.0.1:{p}" for p in ports]
base_s = float(int(time.time()))
clusters, servers = [], []
for r in range(2):
    c = ClusterEngine(ClusterConfig(
        rank=r, n_ranks=2, peers=peers, secret="s", epoch_base_unix_s=base_s,
        engine=DistributedConfig(n_shards=2, device_capacity_per_shard=32,
                                 token_capacity_per_shard=64,
                                 assignment_capacity_per_shard=64,
                                 store_capacity_per_shard=256, channels=4,
                                 batch_capacity_per_shard=16, device="cpu",
                                 wal_dir=f"{tmp}/wal-r{r}"),
        connect_timeout_s=10.0))
    c.attach_forwarding(ForwardQueue(c, f"{tmp}/fwd-r{r}"),
                        SpillRegistry(f"{tmp}/fwd-r{r}/registry"))
    srv = build_cluster_rpc(c.local, "s")
    asyncio.run_coroutine_threadsafe(srv.start(port=ports[r]), loop).result(10)
    clusters.append(c)
    servers.append(srv)
toks = [f"pr-{i}" for i in range(8)]
s = clusters[0].ingest_json_batch([json.dumps({
    "deviceToken": t, "type": "DeviceMeasurement",
    "request": {"name": "t", "value": float(i), "eventDate": int(base_s * 1000) + i}}
    ).encode() for i, t in enumerate(toks)])
clusters[0].flush()
out = {"staged": s["staged"], "owners": sorted({owner_rank(t, 2) for t in toks}),
       "total_at_1": clusters[1].query_events(limit=50)["total"],
       "local_0": clusters[0].local.metrics()["persisted"],
       "local_1": clusters[1].local.metrics()["persisted"]}
for srv in servers:
    asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(10)
for c in clusters:
    c.forward_queue.stop()
    c.spill_registry.close()
    c.close()
loop.call_soon_threadsafe(loop.stop)
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
out["leaked"] = leaked
print(json.dumps(out))
"""


def test_cluster_forwards_with_jax_and_aiohttp_blocked():
    """The cluster planes and the rules oracle import, a spawned demo
    worker's imports load, and a two-rank cluster forwards a mixed-owner
    batch to its owners, where ``jax``, ``sitewhere_tpu`` and ``aiohttp``
    cannot be imported."""
    res = subprocess.run([sys.executable, "-c", _CLUSTER_PROBE, *CLUSTER_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["leaked"] == []
    assert out["owners"] == [0, 1] and out["staged"] == 8
    assert out["total_at_1"] == 8
    assert out["local_0"] + out["local_1"] == 8 and min(out["local_0"], out["local_1"]) > 0


_SHARDED_PROBE = r"""
import json
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.engine import EngineConfig
from sitewhere_tpu_torch.parallel.placement import shard_for_token
from sitewhere_tpu_torch.parallel.router import ShardRouter
from sitewhere_tpu_torch.parallel.sharded import ShardedEngine, SpmdEngine
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from sitewhere_tpu_torch.utils.metrics import MetricsRegistry, export_spmd_metrics

eng = SpmdEngine(EngineConfig(device_capacity=16, token_capacity=32,
                              assignment_capacity=32, store_capacity=256,
                              batch_capacity=16, channels=4, use_native=False),
                 n_shards=2, device="cpu")
wire = [json.dumps({"deviceToken": f"d{i % 5}", "type": "DeviceMeasurement",
                    "request": {"name": "t", "value": float(i), "eventDate": 1000 + i}}
                   ).encode() for i in range(20)]
eng.ingest_json_batch(wire)
eng.flush()
page = eng.query_events(limit=5)
ok = check_conservation(build_ledger(eng)) == []
reg = MetricsRegistry()
export_spmd_metrics(eng, reg)
sh = ShardedEngine(n_shards=2, device_capacity_per_shard=8, token_capacity_per_shard=8,
                   assignment_capacity_per_shard=8, store_capacity_per_shard=64,
                   channels=4, device="cpu")
router = ShardRouter(2, 8, 8, 4)
for t in range(12):
    router.append(EventType.MEASUREMENT, t, 0, t, t, values=[1.0])
sh.step(router.emit())
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({"persisted": eng.metrics()["persisted"], "total": page["total"],
                  "conserved": ok, "sharded": sh.global_metrics()["processed"],
                  "shards": sorted({shard_for_token(f"d{i}", 2) for i in range(5)}),
                  "leaked": leaked}))
"""


def test_sharded_engines_run_with_jax_blocked():
    """The multi-shard engines, the slot map, the router, the shard metrics
    and the conservation stage run end to end where jax and the JAX
    package cannot be imported."""
    res = subprocess.run([sys.executable, "-c", _SHARDED_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"persisted": 20, "total": 20, "conserved": True, "sharded": 12,
                   "shards": [0, 1], "leaked": []}


_DISTRIBUTED_PROBE = r"""
import json
import pathlib
import sys
import tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

from sitewhere_tpu_torch.parallel.distributed import (DistributedConfig,
                                                      DistributedEngine,
                                                      recover_distributed,
                                                      restore_distributed)
from sitewhere_tpu_torch.parallel.reshard import reshard_snapshot
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation

tmp = pathlib.Path(tempfile.mkdtemp())
eng = DistributedEngine(DistributedConfig(
    n_shards=2, device_capacity_per_shard=16, token_capacity_per_shard=32,
    assignment_capacity_per_shard=32, store_capacity_per_shard=128, channels=4,
    batch_capacity_per_shard=16, wal_dir=str(tmp / "wal"), device="cpu"))
wire = [json.dumps({"deviceToken": f"d{i % 5}", "type": "DeviceMeasurement",
                    "request": {"name": "t", "value": float(i), "eventDate": 1000 + i}}
                   ).encode() for i in range(20)]
eng.ingest_json_batch(wire[:10])
eng.flush()
eng.save(tmp / "snap")
eng.ingest_json_batch(wire[10:])
eng.flush()
ok = check_conservation(build_ledger(eng)) == []
eng.wal.close()
back = recover_distributed(tmp / "snap", device="cpu")
reshard_snapshot(tmp / "snap", tmp / "one", 1)
one = restore_distributed(tmp / "one", device="cpu")
feed = eng.make_feed_consumer("g").poll()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({"persisted": back.metrics()["persisted"],
                  "resharded": one.metrics()["persisted"], "feed": len(feed),
                  "total": eng.query_events(limit=5)["total"], "conserved": ok,
                  "leaked": leaked}))
"""


def test_distributed_engine_runs_with_jax_blocked():
    """The mesh engine, its WAL recovery, the offline reshard, the feed and
    the conservation ledger run where jax and the JAX package cannot be
    imported."""
    res = subprocess.run([sys.executable, "-c", _DISTRIBUTED_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"persisted": 20, "resharded": 10, "feed": 20, "total": 20,
                   "conserved": True, "leaked": []}


_SOURCES_PROBE = r"""
import asyncio
import json
import sys
import tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.decoders import (CompositeDecoder,
                                                 JsonBatchEventDecoder,
                                                 JsonDeviceRequestDecoder)
from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator
from sitewhere_tpu_torch.ingest.sources import (EventSourcesManager, InboundEventSource,
                                                InMemoryEventReceiver,
                                                SocketEventReceiver)
from sitewhere_tpu_torch.models import anomaly as tan
from sitewhere_tpu_torch.native.binding import route_payloads
from sitewhere_tpu_torch.parallel.multihost_demo import worker_main

# the demo's worker, as one process of a job of one
worker_main(0, 1, f"file://{tempfile.mkdtemp()}/store", 2, "cpu")

# one DP x TP step on a (1, 1) mesh
dist.init_process_group("gloo", init_method=f"file://{tempfile.mkdtemp()}/store",
                        rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "tp"))
cfg = tan.AnomalyConfig(sensors=2, window=4, hidden=8, lstm_hidden=8, latent=2,
                        dtype=torch.float32)
model = tan.distribute_model(tan.AnomalyModel(cfg, device="cpu"), mesh)
step = tan.make_train_step_dp_tp(model, tan.adamw(model.parameters(), 1e-3), mesh)
loss = float(step(torch.rand(2, 4, 2)))
dist.destroy_process_group()

# a receiver -> decoder -> dedup -> manager -> Engine.process
eng = Engine(EngineConfig(device_capacity=16, token_capacity=32, assignment_capacity=32,
                          store_capacity=256, batch_capacity=16, channels=4),
             device="cpu")
mgr = EventSourcesManager(eng.process, eng.process)
mem, sock = InMemoryEventReceiver(), SocketEventReceiver(framing="newline")
mgr.add_source(InboundEventSource("m", JsonDeviceRequestDecoder(), [mem],
                                  AlternateIdDeduplicator()))
mgr.add_source(InboundEventSource("s", CompositeDecoder(
    lambda p, m: ("batch", p), {"batch": JsonBatchEventDecoder()}), [sock]))
msg = json.dumps({"deviceToken": "a", "type": "DeviceMeasurement",
                  "request": {"name": "t", "value": 1.0, "alternateId": "x"}}).encode()

async def run():
    await mgr.initialize()
    await mgr.start()
    _, w = await asyncio.open_connection("127.0.0.1", sock.bound_port)
    w.write(b"[" + msg + b"]\n")
    await w.drain()
    w.close()
    await asyncio.sleep(0.2)
    await mgr.stop()

mem.submit(msg)
mem.submit(msg)
asyncio.run(run())
eng.flush()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({"finite": loss == loss, "processed": eng.metrics()["processed"],
                  "routes": route_payloads([msg], 3).tolist(), "leaked": leaked}))
"""


def test_demo_worker_tp_step_and_sources_run_with_jax_blocked():
    """The two-process demo's worker, a DP x TP step on a one-rank mesh and
    the event sources into the engine run where jax and the JAX package
    cannot be imported."""
    res = subprocess.run([sys.executable, "-c", _SOURCES_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("MULTIHOST_OK rank=0/1 shards=[0, 1] persisted=48")
    out = json.loads(lines[-1])
    assert out["finite"] and out["processed"] == 2 and out["leaked"] == []
    assert len(out["routes"]) == 1


_WIRE_PROBE = r"""
import asyncio
import json
import struct
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.amqp import AmqpBroker, AmqpClient, RabbitMqEventReceiver
from sitewhere_tpu_torch.ingest.coap import POST, CoapClient, CoapServerEventReceiver
from sitewhere_tpu_torch.ingest.decoders import JsonDeviceRequestDecoder
from sitewhere_tpu_torch.ingest.eventhub import EventHub, EventHubEventReceiver
from sitewhere_tpu_torch.ingest.mqtt import MqttBroker, MqttClient, MqttEventReceiver
from sitewhere_tpu_torch.ingest.sources import EventSourcesManager, InboundEventSource
from sitewhere_tpu_torch.ingest.stomp import ActiveMqBrokerEventReceiver, StompClient
from sitewhere_tpu_torch.ingest.wire_edge import (SWP_MAGIC, WireBatcher, WireEdge,
                                                  WireEdgeConfig)
from sitewhere_tpu_torch.loadgen import WireLoadSpec, build_wire_schedule, run_wire_load
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation

eng = Engine(EngineConfig(device_capacity=64, token_capacity=128, assignment_capacity=128,
                          store_capacity=1024, batch_capacity=16, channels=4), device="cpu")

def msg(tok):
    return json.dumps({"deviceToken": tok, "type": "DeviceMeasurement",
                       "request": {"name": "t", "value": 1.0}}).encode()

async def until(pred):
    for _ in range(1000):
        if pred():
            return
        await asyncio.sleep(0.01)
    raise TimeoutError

async def run():
    out = {}
    edge = WireEdge(eng, WireEdgeConfig(mqtt_port=0, tcp_port=0, flush_rows=4))
    await edge.start()
    res = await run_wire_load("127.0.0.1", edge.mqtt_port,
                              build_wire_schedule(WireLoadSpec(4, 2, 4)))
    r, w = await asyncio.open_connection("127.0.0.1", edge.tcp_port)
    w.write(SWP_MAGIC + b" default json\n" + struct.pack("!I", 5) + b"{bad}"
            + struct.pack("!I", 0))
    await w.drain()
    out["swp"] = struct.unpack("!BI", await r.readexactly(5))
    w.close()
    eng.flush()
    out["wire_ok"] = check_conservation(build_ledger(eng)) == []
    await edge.stop()
    out["acked"] = res.acked
    batcher = WireBatcher(eng, flush_rows=64, auto=False)
    mgr = EventSourcesManager(eng.process, eng.process, batcher=batcher)
    broker, amqp = MqttBroker(), AmqpBroker()
    await broker.start()
    await amqp.start()
    hub = EventHub("h", partition_count=2)
    recvs = {"mqtt": MqttEventReceiver("127.0.0.1", broker.bound_port, topic="in/#"),
             "coap": CoapServerEventReceiver(),
             "amqp": RabbitMqEventReceiver("127.0.0.1", amqp.bound_port, queue="q"),
             "stomp": ActiveMqBrokerEventReceiver("b", "Q", num_consumers=1),
             "hub": EventHubEventReceiver(hub)}
    srcs = {k: mgr.add_source(InboundEventSource(k, JsonDeviceRequestDecoder(), [v]))
            for k, v in recvs.items()}
    await mgr.initialize()
    await mgr.start()
    pub = MqttClient("127.0.0.1", broker.bound_port, "p")
    await pub.connect()
    await pub.publish("in/a", msg("m"), qos=1)
    coap = asyncio.ensure_future(CoapClient("127.0.0.1", recvs["coap"].bound_port).request(
        POST, ["e"], msg("c")))
    ap = AmqpClient("127.0.0.1", amqp.bound_port)
    await ap.connect()
    await ap.publish("", "q", msg("a"))
    sp = StompClient("127.0.0.1", recvs["stomp"].bound_port)
    await sp.connect()
    await sp.send("/queue/Q", msg("s"))
    hub.send(msg("h"), partition_key="h")
    await until(lambda: sum(s.batched_count for s in srcs.values()) == 5)
    batcher.flush()
    out["coap"] = (await coap)["code"]
    await pub.disconnect()
    await ap.close()
    await sp.disconnect()
    await mgr.stop()
    await broker.stop()
    await amqp.stop()
    batcher.close()
    return out

out = asyncio.run(run())
eng.flush()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({**out, "persisted": eng.metrics()["persisted"], "leaked": leaked}))
"""


def test_wire_edge_and_broker_receivers_run_with_jax_blocked():
    """The wire edge (MQTT through ``run_wire_load``, SWP), the conservation
    ledger's wire stage and the five broker receivers over one shared
    ``WireBatcher`` into an engine run where jax and the JAX package cannot
    be imported."""
    res = subprocess.run([sys.executable, "-c", _WIRE_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["acked"] == 8 and out["swp"] == [6, 1] and out["wire_ok"]
    assert out["coap"] == 0x41 and out["persisted"] == 13 and out["leaked"] == []


_SERVICES_PROBE = r"""
import asyncio
import base64
import json
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

from sitewhere_tpu_torch.commands.destinations import (CommandDestination,
                                                       LocalDeliveryProvider,
                                                       MqttDeliveryProvider,
                                                       mqtt_topic_extractor)
from sitewhere_tpu_torch.commands.encoders import (BinaryCommandExecutionEncoder,
                                                   JsonCommandExecutionEncoder)
from sitewhere_tpu_torch.commands.model import DeviceCommand
from sitewhere_tpu_torch.commands.routing import DeviceTypeMappingCommandRouter
from sitewhere_tpu_torch.commands.service import CommandDeliveryService
from sitewhere_tpu_torch.connectors.aws import AwsCredentials, sigv4_headers
from sitewhere_tpu_torch.connectors.base import (AreaFilter, ConnectorHost,
                                                 DeviceTypeFilter, ScriptedFilter)
from sitewhere_tpu_torch.connectors.impl import (EventHubConnector, InMemoryConnector,
                                                 SearchIndexConnector)
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.decoders import JsonDeviceRequestDecoder
from sitewhere_tpu_torch.ingest.eventhub import EventHub
from sitewhere_tpu_torch.ingest.mqtt import MqttBroker, MqttClient
from sitewhere_tpu_torch.labels.manager import LabelGeneratorManager
from sitewhere_tpu_torch.labels.qrcode import qr_matrix
from sitewhere_tpu_torch.management.assets import AssetManagement
from sitewhere_tpu_torch.management.batch import (BatchCommandInvocationHandler,
                                                  BatchOperationManager)
from sitewhere_tpu_torch.management.device_management import DeviceManagement
from sitewhere_tpu_torch.management.schedule import (ScheduleManager,
                                                     command_invocation_executor)
from sitewhere_tpu_torch.management.streams import DeviceStreamManager, DeviceStreamService
from sitewhere_tpu_torch.outbound.zones import ZoneMonitor
from sitewhere_tpu_torch.search.index import EventSearchIndex

eng = Engine(EngineConfig(device_capacity=64, token_capacity=128, assignment_capacity=128,
                          store_capacity=1024, batch_capacity=16, channels=4), device="cpu")
dm = DeviceManagement(eng)
dm.create_area_type("site", "Site")
dm.create_area("plant", "site", "Plant")
dm.create_device_type("meter", "Meter")
dm.create_zone("fence", "plant", "Fence", bounds=[(0, 0), (0, 10), (10, 10), (10, 0)])
for i in range(6):
    dm.create_device(f"d{i}", "meter" if i % 2 else "default", area="plant")
AssetManagement().create_asset_type("truck", "Truck")
zm = ZoneMonitor(eng, dm)
local = LocalDeliveryProvider()
svc = CommandDeliveryService(eng, DeviceTypeMappingCommandRouter({"meter": "local"},
                                                                 default="mqtt"))
svc.registry.create(DeviceCommand(token="ping", device_type="meter", name="ping"))
svc.add_destination(CommandDestination("local", mqtt_topic_extractor(),
                                       JsonCommandExecutionEncoder(), local))
streams = DeviceStreamService(DeviceStreamManager(), svc)
index = EventSearchIndex()
sink = InMemoryConnector("s", filters=[DeviceTypeFilter(eng, ["meter"]),
                                       AreaFilter([eng.areas.lookup("plant")]),
                                       ScriptedFilter(lambda e: False)])
hosts = [ConnectorHost(eng, sink), ConnectorHost(eng, SearchIndexConnector("i", index))]
batch = BatchOperationManager()
batch.register_handler(BatchCommandInvocationHandler(svc))
sched = ScheduleManager()
sched.register_executor("CommandInvocation", command_invocation_executor(svc))
sched.create_schedule("s", "S", "Simple", interval_s=1.0, repeat_count=0)
sched.create_job("j", "s", "CommandInvocation", {"deviceToken": "d1", "commandToken": "ping"})
dec = JsonDeviceRequestDecoder()

def route(envelope):
    for req in dec.decode(json.dumps(envelope).encode(), {}):
        streams.handle_request(req) if streams.handles(req) else eng.process(req)

async def run():
    out = {}
    broker = MqttBroker()
    await broker.start()
    svc.add_destination(CommandDestination("mqtt", mqtt_topic_extractor(),
                                           BinaryCommandExecutionEncoder(),
                                           MqttDeliveryProvider("127.0.0.1",
                                                                broker.bound_port)))
    svc.registry.create(DeviceCommand(token="blink", device_type="default", name="b"))
    got = []
    dev = MqttClient("127.0.0.1", broker.bound_port, "dev")
    await dev.connect()
    dev.on_message = lambda t, p: got.append(p)
    await dev.subscribe("sitewhere/commands/#")
    for i in range(6):
        route({"deviceToken": f"d{i}", "type": "DeviceLocation",
               "request": {"latitude": 5.0 if i < 3 else 50.0, "longitude": 5.0}})
    route({"deviceToken": "d1", "type": "DeviceStream",
           "request": {"streamId": "v", "contentType": "video/mjpeg"}})
    route({"deviceToken": "d1", "type": "DeviceStreamData",
           "request": {"streamId": "v", "sequenceNumber": 0,
                       "data": base64.b64encode(b"f0").decode()}})
    eng.flush()
    out["alerts"] = await zm.pump()
    svc.invoke("d1", "ping")
    svc.invoke("d2", "blink")
    out["pumped"] = await svc.pump()
    op = batch.create_operation("op", "InvokeCommand", ["d3", "d5"], {"commandToken": "ping"})
    out["batch"] = (await batch.process_operation("op")).counts()["SUCCEEDED"]
    out["fired"] = await sched.fire_due(1_000_000.0)
    for _ in range(200):
        if got:
            break
        await asyncio.sleep(0.01)
    eng.flush()
    for h in hosts:
        await h.pump()
    await EventHubConnector("h", EventHub("o", partition_count=1)).process_event(sink.events[0])
    await dev.disconnect()
    for d in svc.destinations.values():
        await d.stop()
    await broker.stop()
    out["mqtt"] = len(got)
    return out

out = asyncio.run(run())
out.update(local=len(local.delivered), sink=len(sink.events),
           hits=len(index.search("type:ALERT")), qr=len(qr_matrix("x")),
           label=LabelGeneratorManager().list_generators()[0]["id"],
           sig=sigv4_headers(AwsCredentials("a", "b"), "sqs", "POST", "https://q/x",
                             b"", amz_date="20250101T000000Z")["x-amz-date"],
           zones=str(zm._verts.device), syncs=zm.stats["syncs"],
           stream=streams.manager.read_all("v").decode())
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({**out, "leaked": leaked}))
"""


def test_services_run_with_jax_blocked():
    """The entity and outbound services wired by hand over one engine (device
    management, assets, the zone monitor, command delivery over a local and
    an MQTT destination, stream requests through ``DeviceStreamService``,
    batch and schedule managers, the connectors with every filter kind, the
    search index, labels and SigV4), their lazy imports included, run a
    small stream where jax and the JAX package cannot be imported."""
    res = subprocess.run([sys.executable, "-c", _SERVICES_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["alerts"] == 3 and out["syncs"] == 1 and out["zones"] == "cpu"
    assert out["pumped"] == 2 and out["batch"] == 2 and out["fired"] == 1
    assert out["local"] == 5 and out["mqtt"] >= 1 and out["stream"] == "f0"
    assert out["sink"] > 0 and out["hits"] == 3 and out["qr"] == 21
    assert out["label"] == "qrcode" and out["sig"] == "20250101T000000Z"
    assert out["leaked"] == []


_TRAIN_PROBE = r"""
import json
import math
import pathlib
import sys
import tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import torch

from sitewhere_tpu_torch.convert import adamw_state_from_optax
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.models.anomaly import (AnomalyConfig, AnomalyModel, adamw,
                                                loss_fn, make_train_step)
from sitewhere_tpu_torch.models.service import AnalyticsService
from sitewhere_tpu_torch.rules import RuleSetWatcher, RulesManager

eng = Engine(EngineConfig(device_capacity=16, token_capacity=32, assignment_capacity=32,
                          store_capacity=256, batch_capacity=16, channels=4,
                          analytics_devices=8, analytics_window=4, use_native=False),
             device="cpu")
for t in range(6):
    for d in range(4):
        eng.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                                   device_token=f"d{d}",
                                   measurements={"a": float(t * d), "b": float(t)}))
eng.flush()
cfg = AnomalyConfig(sensors=4, window=4, hidden=8, lstm_hidden=8, latent=2)
svc = AnalyticsService(eng, cfg)
loss = svc.train_on_live(batch_size=4, steps=2)
tmp = pathlib.Path(tempfile.mkdtemp())
svc.save_model(tmp / "ckpt")
back = AnalyticsService(eng, cfg, seed=1)
back.restore_model(tmp / "ckpt")
same = all(torch.equal(back.model.state_dict()[k], v)
           for k, v in svc.model.state_dict().items())
mgr = RulesManager(eng, active=False)
rules = tmp / "rules.json"
rules.write_text(json.dumps({"name": "r", "rules": [
    {"name": "hot", "kind": "threshold", "channel": "a", "op": ">", "value": 9.0}]}))
w = RuleSetWatcher(mgr, rules, interval_s=0.01)
w.start()
w.stop()
mgr.promote()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(math.isfinite(loss), same, mgr.active, mgr.spill_rollups(), leaked)
sys.exit(0 if math.isfinite(loss) and same and mgr.active and not leaked else 1)
"""


def test_training_and_rules_runtime_run_with_jax_blocked():
    """Training, the checkpoint, standby promotion, the watcher and the
    rollup spill run in a process where importing ``jax``, ``optax``,
    ``flax``, ``orbax`` or the JAX package raises."""
    res = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    assert res.stdout.split() == ["True", "True", "True", "{'spilled':", "0,",
                                  "'rollups':", "0}", "[]"]


_WORKER_PROBE = r"""
import sys
import threading

BLOCKED = ("torch", "jax", "jaxlib", "flax", "optax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the decode worker tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import multiprocessing as mp
import numpy as np
from multiprocessing import shared_memory

from sitewhere_tpu_torch.ingest import workers

# one decode job through the worker's own loop, in this torch-less process
max_msgs, max_bytes, channels = 8, 4096, 4
shm_in = shared_memory.SharedMemory(create=True, size=workers._HDR * 8
                                    + (max_msgs + 1) * 8 + max_bytes)
shm_out = shared_memory.SharedMemory(create=True,
                                     size=workers._out_bytes(max_msgs, channels))
parent, child = mp.Pipe()
t = threading.Thread(target=workers._worker_main,
                     args=(child, shm_in.name, shm_out.name, max_msgs, max_bytes,
                           channels, 64))
t.start()
pay = [b'{"deviceToken": "wk-1", "type": "DeviceMeasurement",'
       b' "request": {"name": "temp", "value": 21.5}}']
hdr = np.ndarray((workers._HDR,), np.int64, buffer=shm_in.buf)
offs = np.ndarray((max_msgs + 1,), np.int64, buffer=shm_in.buf, offset=workers._HDR * 8)
data_off = workers._HDR * 8 + (max_msgs + 1) * 8
offs[0], offs[1] = 0, len(pay[0])
shm_in.buf[data_off:data_off + len(pay[0])] = pay[0]
hdr[0], hdr[1] = 1, len(pay[0])
parent.send(("decode",))
reply = parent.recv()
parent.send(None)
t.join(timeout=30)
shm_in.close(); shm_in.unlink(); shm_out.close(); shm_out.unlink()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(reply[0], reply[1], reply[3], reply[4])
sys.exit(1 if leaked or reply[:2] != ("done", 1) else 0)
"""


def test_decode_worker_entry_runs_with_torch_blocked():
    """A spawned ``DecodeWorkerPool`` child imports only the worker's module
    chain: ``_worker_main`` imports and decodes a batch in a process where
    importing ``torch`` (or JAX, or the JAX package) raises."""
    res = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    assert res.stdout.split()[:3] == ["done", "1", "['wk-1']"]


def test_entry_points_raise_without_a_gpu(tmp_path):
    """Called with no ``device``, an entry point asks for CUDA and raises on
    a machine without one, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from sitewhere_tpu_torch.core.events import EventBatch, HostEventBuffer
    from sitewhere_tpu_torch.engine import Engine, EngineConfig
    from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, AnomalyModel
    from sitewhere_tpu_torch.models.transformer import (TelemetryTransformer,
                                                        TransformerConfig)
    from sitewhere_tpu_torch.ops.rules import RollupBlock, RuleBlock
    from sitewhere_tpu_torch.pipeline import PipelineState
    from sitewhere_tpu_torch.utils.checkpoint import (recover_engine,
                                                      restore_engine,
                                                      save_engine)

    small = EngineConfig(device_capacity=8, token_capacity=8,
                         assignment_capacity=8, store_capacity=64,
                         batch_capacity=8)
    save_engine(Engine(small, device="cpu"), tmp_path / "snap")
    calls = [
        lambda: Engine(small),
        lambda: Engine(dataclasses.replace(small, use_native=False)),
        lambda: restore_engine(tmp_path / "snap"),
        lambda: recover_engine(tmp_path / "snap"),
        lambda: PipelineState.create(8, 8, 8, 64),
        lambda: EventBatch.zeros(4),
        lambda: HostEventBuffer(4).emit(),
        lambda: AnomalyModel(AnomalyConfig(sensors=2, window=4, hidden=8,
                                           lstm_hidden=8, latent=2)),
        lambda: TelemetryTransformer(TransformerConfig(sensors=2, d_model=16,
                                                       heads=1, layers=1, mlp=8)),
        lambda: RuleBlock.zeros(
            {k: [0] for k in ("active", "etype", "tenant", "ch_a", "val_a",
                              "ch_b", "val_b", "window_ms")},
            ((0, 0, 3, 0, -1),), groups=4),
        lambda: RollupBlock.zeros(
            {k: [0] for k in ("channel", "scope", "etype", "window_ms")},
            groups=4, buckets=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_services_on_a_default_engine_raise_without_a_gpu():
    """``DeviceManagement`` and ``ZoneMonitor`` over an ``Engine()`` built
    with no ``device`` ask for the card and raise without one, as every
    entry point does; the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from sitewhere_tpu_torch.engine import Engine, EngineConfig
    from sitewhere_tpu_torch.management.device_management import DeviceManagement
    from sitewhere_tpu_torch.outbound.zones import ZoneMonitor

    small = EngineConfig(device_capacity=8, token_capacity=8, assignment_capacity=8,
                         store_capacity=64, batch_capacity=8)
    for call in (lambda: DeviceManagement(Engine(small)),
                 lambda: ZoneMonitor(Engine(small), None)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    eng = Engine(small, device="cpu")
    zm = ZoneMonitor(eng, DeviceManagement(eng))
    zm._refresh_zones()
    assert zm.device == eng.device and zm._verts.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """``python3 chip_smoke.py`` exits non-zero and prints no result line
    when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_ab_records_a_tree_without_a_card_and_fails(tmp_path):
    """``chip_ab.py`` runs each tree in a process of its own: without a
    card the tree's record carries the error, no timings, and the run
    exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = tmp_path / "ab.json"
    res = subprocess.run([sys.executable, str(REPO / "chip_ab.py"), "--out", str(out),
                          "--shapes", "d64_bf16", str(REPO)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 1, res.stderr
    (run,) = json.loads(out.read_text())["runs"]
    assert "no CUDA device" in run["error"] and "timings" not in run


def test_cluster_entry_points_raise_without_a_gpu(tmp_path):
    """A cluster rank, ``run_rank`` and a standby reset built with no
    device ask for CUDA and raise on a machine without one; the demo's
    spawner defaults to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import inspect

    from sitewhere_tpu_torch.parallel.cluster import ClusterConfig, ClusterEngine
    from sitewhere_tpu_torch.parallel.cluster_demo import spawn_cluster_demo, worker_main
    from sitewhere_tpu_torch.parallel.distributed import DistributedConfig
    from sitewhere_tpu_torch.parallel.rank_runtime import RankConfig, run_rank

    small = DistributedConfig(n_shards=1, device_capacity_per_shard=8,
                              token_capacity_per_shard=8,
                              assignment_capacity_per_shard=8,
                              store_capacity_per_shard=64,
                              batch_capacity_per_shard=8)
    cfg = ClusterConfig(rank=0, n_ranks=1, peers=["127.0.0.1:1"], secret="s",
                        epoch_base_unix_s=0.0, engine=small)
    for call in (lambda: ClusterEngine(cfg),
                 lambda: run_rank(RankConfig(cluster=cfg, require_wal=False))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    for fn in (spawn_cluster_demo, worker_main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
