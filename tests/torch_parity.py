"""Shared helpers for the parity tests between ``sitewhere_tpu`` (JAX, the
reference) and ``sitewhere_tpu_torch`` (the PyTorch port).

Inputs are made with numpy from a seed and handed to both sides; results
come back to numpy and are compared leaf by leaf. Integer and bool leaves
must be byte-identical; float leaves that the step only copies must be
equal too.
"""

from __future__ import annotations

import dataclasses
import pathlib
import pickle

import numpy as np

INT32_MIN = np.iinfo(np.int32).min
BATCH_FIELDS = ("valid", "etype", "token_id", "tenant_id", "ts_ms",
                "received_ms", "values", "vmask", "aux", "seq")


def to_np(x) -> np.ndarray:
    """A JAX array, numpy array or torch tensor as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_leaf_equal(ref, got, name: str) -> None:
    a, b = to_np(ref), to_np(got)
    assert a.dtype == b.dtype, f"{name}: dtype {b.dtype} != reference {a.dtype}"
    assert a.shape == b.shape, f"{name}: shape {b.shape} != reference {a.shape}"
    if not np.array_equal(a, b):
        bad = np.argwhere(a != b)[:5]
        raise AssertionError(
            f"{name}: {int(np.sum(a != b))} elements differ, first at "
            f"{bad.tolist()}: reference {a[tuple(bad[0])]!r} port "
            f"{b[tuple(bad[0])]!r}")


def assert_tree_equal(ref, got, name: str = "state") -> None:
    """Every field of the port's dataclass ``got`` against the same-named
    attribute of the reference object ``ref``, recursively."""
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        r = getattr(ref, f.name)
        path = f"{name}.{f.name}"
        if g is None or r is None:
            assert g is None and r is None, f"{path}: one side is None"
        elif dataclasses.is_dataclass(g):
            assert_tree_equal(r, g, path)
        else:
            assert_leaf_equal(r, g, path)


def make_batch(rng: np.random.Generator, capacity: int, channels: int,
               n_tokens: int, token_capacity: int, window: int,
               ts0: int = 0) -> dict[str, np.ndarray]:
    """One seeded event batch as numpy columns, shaped to probe the port:
    tokens repeat (in-batch dedup), some are negative or past the token
    capacity (must dead-letter), tenants include NULL_ID and values past
    the 64-bucket counter grid, timestamps collide (stable-sort ties) and
    include the INT32_MIN sentinel region, aux1 alternate ids repeat
    (dedup counter), location rows sometimes lack coordinates, and the
    padding rows past ``valid`` hold garbage that must stay masked.

    No token gets more than ``window`` measurement rows in one batch: past
    that, two rows of one device share a telemetry-window slot and the JAX
    op leaves the winner to XLA (models/windows.py)."""
    b, c = capacity, channels
    tok = rng.integers(0, n_tokens, b).astype(np.int32)
    odd = rng.random(b)
    tok[odd < 0.04] = -1 - rng.integers(0, 5, int(np.sum(odd < 0.04)))
    far = (odd >= 0.04) & (odd < 0.08)
    tok[far] = token_capacity + rng.integers(0, 9, int(np.sum(far)))
    etype = rng.choice(6, b, p=[0.55, 0.15, 0.12, 0.06, 0.06, 0.06]).astype(np.int32)
    # a token keeps its tenant (mod 3) except for NULL_ID rows (match any
    # device) and a few strays (tenant mismatch -> miss; 65 -> bucket 1)
    tenant = (np.abs(tok) % 3).astype(np.int32)
    pick = rng.random(b)
    tenant[pick < 0.1] = -1
    tenant[(pick >= 0.1) & (pick < 0.15)] = rng.choice([2, 65])
    ts = (ts0 + rng.integers(0, 12, b)).astype(np.int32)
    ts[rng.random(b) < 0.03] = INT32_MIN
    ts[rng.random(b) < 0.03] = INT32_MIN + 1
    values = rng.standard_normal((b, c)).astype(np.float32)
    values[etype == 2, 0] = rng.integers(0, 4, int(np.sum(etype == 2)))
    vmask = rng.random((b, c)) < 0.8
    aux = np.stack([rng.integers(-1, 4, b),
                    np.where(rng.random(b) < 0.5, -1, rng.integers(0, 6, b))],
                   1).astype(np.int32)
    n = int(rng.integers(b * 3 // 4, b + 1))
    valid = np.arange(b) < n
    # cap measurement rows per token and batch at the window length
    for t in np.unique(tok):
        rows = np.nonzero(valid & (tok == t) & (etype == 0))[0]
        etype[rows[window:]] = 1
    return dict(valid=valid, etype=etype, token_id=tok, tenant_id=tenant,
                ts_ms=ts, received_ms=(ts0 + np.zeros(b)).astype(np.int32),
                values=values, vmask=vmask, aux=aux,
                seq=np.arange(b, dtype=np.int32))


def strip_trace(summary: dict) -> dict:
    """An ingest summary without its ``trace_id``, which both packages
    return (a 32-hex id, different per engine)."""
    out = dict(summary)
    tid = out.pop("trace_id")
    assert isinstance(tid, str) and len(tid) == 32, tid
    return out


def analytics_stream(seed: int, n_full: int, n_short: int, window: int,
                     channels: int, outlier: int | None = None) -> list[dict]:
    """Measurement requests (keyword dicts for ``DecodedRequest``, each
    side builds its own) that fill the telemetry windows of devices
    ``an-0 .. an-{n_full-1}`` with ``window + 3`` seeded samples and give
    ``n_short`` more devices fewer than ``window`` (never eligible for
    training or scoring at ``min_fill=window``). Channel ``k`` is the
    measurement ``m{k}``: a per-device sinusoid plus noise; device
    ``outlier`` (if given) reads white noise instead, which no model
    fitted to the others forecasts."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(window + 3):
        for d in range(n_full + n_short):
            if d >= n_full and t >= window // 2:
                continue
            vals = np.sin(t / 3 + d + np.arange(channels)) + \
                0.1 * rng.standard_normal(channels)
            if d == outlier:
                vals = 3.0 * rng.standard_normal(channels)
            rows.append(dict(device_token=f"an-{d}",
                             measurements={f"m{k}": float(v)
                                           for k, v in enumerate(vals)},
                             event_ts_ms=1_700_000_000_000 + 1000 * t + d))
    return rows


def spy_batches(svc) -> list[np.ndarray]:
    """Every batch an ``AnalyticsService``'s train step is handed (either
    package: the batch is the step's last argument), copied to numpy."""
    seen, inner = [], svc._train

    def spy(*args):
        seen.append(to_np(args[-1]).copy())
        return inner(*args)

    svc._train = spy
    return seen


class StopAfter:
    """A stop event for ``AnalyticsService.run`` that lets exactly
    ``iterations`` iterations through."""

    def __init__(self, iterations: int = 1):
        self.iterations = iterations
        self.calls = 0

    def is_set(self) -> bool:
        self.calls += 1
        return self.calls > self.iterations


# ----------------------------------------------------------------- gloo ranks

def run_on_gloo_ranks(fn, world: int, tmp, *args) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes that form
    one gloo group through a ``file://`` store in ``tmp`` (no port is
    bound), each with ``torch.set_num_threads(1)``; returns each rank's
    return value (pickled through ``tmp``). ``fn`` and ``args`` must pickle:
    a module-level function of an importable module, numpy arrays."""
    import torch.multiprocessing as mp

    tmp = pathlib.Path(tmp)
    mp.spawn(_gloo_child, args=(world, str(tmp), fn, args), nprocs=world, join=True)
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _gloo_child(rank: int, world: int, tmp: str, fn, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    pathlib.Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def sp_worker(rank: int, world: int, case: dict) -> dict:
    """The port's sequence-parallel functions on one gloo rank, for
    ``tests/test_torch_ring_attention.py``: every rank gets the whole seeded
    inputs and returns numpy results. ``case``: ``qkv`` (q, k, v and an
    output gradient ``do``, [B, S, H, D] float32), ``x`` [B, S, C],
    ``cfg`` (``TransformerConfig`` keywords, float32) and ``state`` (the
    model's ``state_dict`` as numpy)."""
    import torch
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_fn

    from sitewhere_tpu_torch.models import transformer as ttf
    from sitewhere_tpu_torch.parallel import ring_attention as rat

    out: dict = {}
    q, k, v, do = (torch.from_numpy(a) for a in case["qkv"])
    for name, fn in (("ring", rat.ring_attention_sharded),
                     ("ulysses", rat.ulysses_attention_sharded)):
        for causal in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            res = fn(*leaves, causal=causal)
            (res * do).sum().backward()
            key = f"{name}_{'causal' if causal else 'full'}"
            out[key] = res.detach().numpy()
            out[key + "_grads"] = [t.grad.numpy() for t in leaves]

    cfg = ttf.TransformerConfig(**case["cfg"], dtype=torch.float32)
    model = ttf.TelemetryTransformer(cfg, device="cpu")
    model.load_state_dict({n: torch.from_numpy(a) for n, a in case["state"].items()})
    x = torch.from_numpy(case["x"])
    scores = ttf.forecast_scores_sp(model, x)
    scores.mean().backward()
    out["scores"] = scores.detach().numpy()
    out["grads"] = {n: p.grad.numpy() for n, p in model.named_parameters()}

    # the trap: torch's autograd-aware all_reduce sums the gradient again
    local = torch.full((3,), float(rank + 1), requires_grad=True)
    dist_fn.all_reduce(local.clone()).sum().backward()
    naive = local.grad.clone()
    local.grad = None
    rat.all_sum(local).sum().backward()
    out["all_reduce_grad"] = naive.numpy()
    out["all_sum_grad"] = local.grad.numpy()
    out["world"] = dist.get_world_size()
    return out


def anomaly_tp_worker(rank: int, world: int, cases: list) -> list:
    """The port's DP×TP anomaly training on one gloo rank, for
    ``tests/test_torch_anomaly_tp.py``. Each case: ``cfg`` (``AnomalyConfig``
    keywords, float32), ``mesh`` ((dp, tp), dp * tp = ``world``),
    ``state`` (the single-device ``state_dict`` as numpy), ``x`` (the whole
    batch) and ``steps`` (0: placements only). Returns, for each case, the
    placements by parameter (strings) before and after, every parameter's
    local shard as it was placed, each step's loss and gradients (the
    dp-averaged ones the optimizer took) and the gathered parameters after
    the steps (single-device layout)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from sitewhere_tpu_torch.models import anomaly as tan

    out = []
    for case in cases:
        cfg = tan.AnomalyConfig(**case["cfg"], dtype=torch.float32)
        model = tan.AnomalyModel(cfg, device="cpu")
        model.load_state_dict({n: torch.from_numpy(a) for n, a in case["state"].items()})
        mesh = init_device_mesh("cpu", case["mesh"], mesh_dim_names=("dp", "tp"))
        dmodel = tan.distribute_model(model, mesh)

        def placements():
            return {n: [str(pl) for pl in p.placements]
                    for n, p in dmodel.named_parameters()}

        res = {"shardings": {n: [str(pl) for pl in pls] for n, pls in
                             tan.param_shardings(model, mesh).items()},
               "before": placements(),
               "local": {n: p.to_local().detach().numpy().copy()
                         for n, p in dmodel.named_parameters()},
               "coords": [mesh.get_local_rank("dp"), mesh.get_local_rank("tp")]}
        if case["steps"]:
            opt = tan.adamw(dmodel.parameters(), 1e-3)
            step = tan.make_train_step_dp_tp(dmodel, opt, mesh)
            stepper, res["grads"] = opt.step, []

            def keep_grads(*a, **kw):
                # the dp-averaged gradients the optimizer is about to take
                res["grads"].append({n: t.numpy() for n, t in
                                     tan.full_state_dict(dmodel, grads=True).items()})
                return stepper(*a, **kw)

            opt.step = keep_grads
            x = torch.from_numpy(case["x"])
            res["losses"] = [float(step(x)) for _ in range(case["steps"])]
            res["after"] = placements()
            res["params"] = {n: t.numpy() for n, t in tan.full_state_dict(dmodel).items()}
        out.append(res)
    return out


def multihost_worker(rank: int, world: int) -> dict:
    """The port's sharded engine on one gloo rank of a job whose shards
    span processes, for ``tests/test_torch_multihost.py``: the global
    numbering, the refusals, and the sums over the group; and, in the
    same group, engines not given it, which keep their shards local."""
    import torch.distributed as dist

    from sitewhere_tpu_torch.core.events import HostEventBuffer
    from sitewhere_tpu_torch.core.types import EventType
    from sitewhere_tpu_torch.parallel import multihost
    from sitewhere_tpu_torch.parallel.distributed import (DistributedConfig,
                                                          DistributedEngine)
    from sitewhere_tpu_torch.parallel.sharded import ShardedEngine

    group = dist.group.WORLD
    sizes = dict(device_capacity_per_shard=16, token_capacity_per_shard=32,
                 assignment_capacity_per_shard=32, store_capacity_per_shard=64,
                 channels=4, device="cpu")
    eng = ShardedEngine(n_shards=2, process_group=group, **sizes)
    local = multihost.local_shard_ids(eng.mesh, group)
    out = {"local": local, "n_shards": eng.n_shards, "n_local": eng.n_local,
           "offset": eng.shard_offset, "refused": {}}
    batches = {}
    for s in local:
        buf = HostEventBuffer(8, channels=4)
        for k in range(s + 1):          # shard s gets s + 1 events
            buf.append(EventType.MEASUREMENT, token_id=k, tenant_id=0, ts_ms=10 + k,
                       received_ms=10 + k, values=[1.0])
        batches[s] = buf.emit_host()
    try:
        multihost.assemble_stacked_batch(eng.mesh, {local[0]: batches[local[0]]}, group)
    except ValueError as e:
        out["refused"]["assemble"] = str(e)
    eng.step(multihost.assemble_stacked_batch(eng.mesh, batches, group))
    out["metrics"] = eng.global_metrics()
    out["sum"] = multihost.all_sum([rank + 1, 10], group)
    out["missing"] = eng.presence_sweep(1000, 0)
    out["summary_shard"] = eng.device_state_summary(local[-1], 0)["shard"]
    for what, fn in (("query_events", eng.query_events),
                     ("save", lambda: eng.save("/nonexistent")),
                     ("exchange", lambda: ShardedEngine(n_shards=2, exchange=True,
                                                        bucket_capacity=8,
                                                        process_group=group,
                                                        **sizes).step(batches))):
        try:
            fn()
        except ValueError as e:
            out["refused"][what] = str(e)

    # engines built in the same 2-rank group without being given it: the
    # shards are this process's own, numbered from 0, counted alone
    alone = ShardedEngine(n_shards=2, **sizes)
    mine = multihost.local_shard_ids(alone.mesh)
    alone.step(multihost.assemble_stacked_batch(
        alone.mesh, {s: batches[local[s]] for s in mine}))
    dcfg = DistributedConfig(n_shards=2, device_capacity_per_shard=16,
                             token_capacity_per_shard=32,
                             assignment_capacity_per_shard=32,
                             store_capacity_per_shard=64, channels=4,
                             device="cpu", use_native=False)
    deng = DistributedEngine(dcfg)
    out["alone"] = {"local": mine, "n_shards": alone.n_shards, "n_local": alone.n_local,
                    "offset": alone.shard_offset, "metrics": alone.global_metrics(),
                    "events": alone.query_events()["total"],
                    "distributed_n_shards": deng.n_shards,
                    "distributed_sharded": [deng.sharded.n_shards, deng.sharded.n_local],
                    "buffer_shards": deng._buf.n_shards}
    return out
