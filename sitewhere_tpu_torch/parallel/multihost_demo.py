"""Two-process execution harness: the sharded engine RUNNING as 2 processes
(port of ``sitewhere_tpu/parallel/multihost_demo.py``).

JAX runs one global mesh that spans the processes; each process stages the
batches of the shards whose devices it addresses, and the step runs as one
SPMD program. The port has no cross-process mesh: each process keeps its
own shards (``ShardedEngine`` over a mesh of its own devices, given the
process group its shards span) and numbers them in one global numbering
(``parallel/multihost.local_shard_ids`` over that group: process ``r`` of
a job with ``k`` shards a process owns ``r*k ... r*k + k - 1``), and the
global counts (metrics, the store scan, the presence sweep) are summed
over the group (``multihost.all_sum``).

The reductions are a few host integers, so the group is gloo in every
case: on one GPU, NCCL refuses two ranks on one device, while gloo lets
both processes keep their shards on ``cuda:0``. The store is a
``file://`` path, so no port is probed and no start can race for one.

``worker_main`` is one process of the job; ``spawn_two_process_demo``
launches a 2-process run and returns its two ``MULTIHOST_OK`` lines,
which carry the same fields as the JAX demo's.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

_PACKAGE_PARENT = str(pathlib.Path(__file__).resolve().parents[2])


def worker_main(rank: int, nproc: int, store: str, devices_per_proc: int = 4,
                device: str = "cuda") -> None:
    """One process of the multi-process job: ``devices_per_proc`` shards on
    ``device`` (a missing card raises), reductions over a gloo group whose
    store is ``store`` (a ``file://`` URL). Prints one ``MULTIHOST_OK`` line
    and one ``MULTIHOST_PLACED`` line on success; any failed check exits
    nonzero."""
    import torch
    import torch.distributed as dist

    from sitewhere_tpu_torch.compat import resolve_device
    from sitewhere_tpu_torch.core.events import HostEventBuffer
    from sitewhere_tpu_torch.core.types import EventType
    from sitewhere_tpu_torch.parallel import multihost
    from sitewhere_tpu_torch.parallel.sharded import ShardedEngine, _leaves, _sweep_shards

    dev = resolve_device(device)
    torch.set_num_threads(1)
    assert multihost.initialize(store, nproc, rank, backend="gloo")
    try:
        assert dist.get_world_size() == nproc, dist.get_world_size()
        group = dist.group.WORLD        # the job's shards span every process
        n_global = nproc * devices_per_proc
        eng = ShardedEngine(
            n_shards=devices_per_proc, device_capacity_per_shard=64,
            token_capacity_per_shard=128, assignment_capacity_per_shard=128,
            store_capacity_per_shard=512, channels=4, device=dev,
            process_group=group)
        assert eng.n_shards == n_global, eng.n_shards
        local = multihost.local_shard_ids(eng.mesh, group)
        assert len(local) == devices_per_proc, local
        # disjoint ownership: rank r owns exactly its block of shard ids
        assert local == list(range(rank * devices_per_proc,
                                   (rank + 1) * devices_per_proc)), local

        # each process ingests events ONLY for its own shards, 8 events a
        # shard with shard-local device ids, in THREE steps: registration
        # (the miss path), lookup hits on the same devices, then a
        # later-timestamped round
        per_shard = 8

        def make_stacked(ts0: int) -> list:
            batches = {}
            for s in local:
                buf = HostEventBuffer(16, channels=4)
                for k in range(per_shard):
                    buf.append(EventType.MEASUREMENT, token_id=k, tenant_id=0,
                               ts_ms=ts0 + k, received_ms=ts0 + k,
                               values=[float(s * 100 + k)])
                batches[s] = buf.emit_host()
            return multihost.assemble_stacked_batch(eng.mesh, batches, group)

        for step_i, ts0 in enumerate((1000, 2000, 3000)):
            eng.step(make_stacked(ts0))
            # global metrics after EVERY step, summed over the group: every
            # process must read the same totals
            m = eng.global_metrics()
            expect = per_shard * n_global * (step_i + 1)
            assert m["persisted"] == expect, (step_i, m)
        assert m["registered"] == per_shard * n_global, m   # first step only
        # "found" counts every resolved event, including just-registered
        # ones re-looked-up within their own step
        assert m["found"] == 3 * per_shard * n_global, m

        # the global store scan, from EVERY process
        n_valid, n_late = multihost.all_sum([
            sum(int(st.store.valid.sum()) for st in eng.shards),
            sum(int((st.store.valid & (st.store.ts_ms >= 3000)).sum())
                for st in eng.shards)], group)
        assert n_valid == 3 * per_shard * n_global, n_valid
        assert n_late == per_shard * n_global, n_late

        # the presence sweep on every shard with a 0 ms horizon: every
        # registered device of every shard goes MISSING
        eng.shards, masks = _sweep_shards(eng.shards, 10_000, 0)
        (n_missing,) = multihost.all_sum([sum(int(mk.sum()) for mk in masks)], group)
        assert n_missing == per_shard * n_global, n_missing

        placed = {str(t.device) for st in eng.shards for t in _leaves(st)}
        assert placed == {str(dev)}, placed
        n_tensors = sum(1 for st in eng.shards for _ in _leaves(st))
        print(f"MULTIHOST_OK rank={rank}/{nproc} shards={local} "
              f"persisted={m['persisted']} store_valid={n_valid} "
              f"found={m['found']} missing={n_missing}", flush=True)
        print(f"MULTIHOST_PLACED rank={rank}/{nproc} device={dev} "
              f"tensors={n_tensors}", flush=True)
    finally:
        dist.destroy_process_group()


def run_two_process_demo(devices_per_proc: int = 4, device: str = "cuda",
                         timeout_s: float = 240.0) -> dict:
    """Launch the 2-process job and check it: ``{"ok": [...], "placed":
    [...], "seconds": s}`` with each rank's ``MULTIHOST_OK`` and
    ``MULTIHOST_PLACED`` line in rank order, and the wall time from the
    launch to the last exit. Raises with every failed rank's output; a
    rank that outlives ``timeout_s`` is killed, with every other."""
    tmp = tempfile.mkdtemp(prefix="swtpu-multihost-")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             "from sitewhere_tpu_torch.parallel.multihost_demo import worker_main;"
             f"worker_main({r}, 2, {('file://' + tmp + '/store')!r}, "
             f"{devices_per_proc}, {device!r})"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)
    ]
    ok, placed, errs = [], [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                # one rank failing fast leaves the other stuck in a
                # collective: the earlier failures say why
                raise RuntimeError(
                    f"rank {r} timed out after {timeout_s}s"
                    + ("; earlier failures:\n" + "\n".join(errs) if errs else ""))
            lines = out.splitlines()
            got = [ln for ln in lines if ln.startswith("MULTIHOST_OK")]
            where = [ln for ln in lines if ln.startswith("MULTIHOST_PLACED")]
            if p.returncode != 0 or not got or not where:
                errs.append(f"rank {r} rc={p.returncode}\n{out}\n{err[-2000:]}")
            else:
                ok.append(got[0])
                placed.append(where[0])
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if errs:
        raise RuntimeError("multi-process demo failed:\n" + "\n".join(errs))
    return {"ok": ok, "placed": placed, "seconds": time.perf_counter() - t0}


def spawn_two_process_demo(devices_per_proc: int = 4, device: str = "cuda",
                           timeout_s: float = 240.0) -> list[str]:
    """Launch the 2-process job and return the two ``MULTIHOST_OK`` lines
    (the JAX demo's contract). The store is a file, so there is no port
    race to retry."""
    return run_two_process_demo(devices_per_proc, device, timeout_s)["ok"]
