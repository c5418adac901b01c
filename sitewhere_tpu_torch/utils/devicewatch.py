"""Device-plane telemetry: the memory half (port of the memory ledger,
``device_memory_payload``, ``export_devicewatch`` and
``capture_device_profile`` of ``sitewhere_tpu/utils/devicewatch.py``).

* :func:`memory_ledger` — scrape-time accounting of everything one engine
  keeps resident: its state tables (bytes from each tensor's shape and
  dtype), the pinned staging arenas and the archive's decoded-segment
  cache, plus the caching allocator's view of the card
  (``torch.cuda.memory_allocated`` / ``memory_reserved`` for the JAX
  package's live-array count, ``torch.cuda.memory_stats`` for its backend
  allocator stats). On a CPU engine the allocator fields are None.
* :func:`export_devicewatch` — the ``swtpu_device_mem_*`` gauges (high-
  watermarks reset on scrape) and the query-path device-time harvest.
* :func:`capture_device_profile` — a ``torch.profiler`` capture of a few
  milliseconds of whatever the process runs, as a Chrome trace.

The JAX module's compile and retrace watchdog has nothing to watch in
eager torch: no program is traced or compiled per shape. Its posture,
``compileFamilies``, is therefore empty here.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time

import torch

from sitewhere_tpu_torch.utils.metrics import REGISTRY, devicewatch_metrics


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a state tree (dataclasses, tuples, lists,
    dicts), from shape and dtype."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        return sum(tree_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(tree_nbytes(x) for x in tree.values())
    return 0


def _cuda_device(engine) -> torch.device | None:
    dev = getattr(engine, "device", None)
    return dev if dev is not None and dev.type == "cuda" else None


def live_array_stats(device: torch.device | None) -> dict | None:
    """The caching allocator's live and reserved bytes on ``device`` (the
    counterpart of the JAX package's process-wide live arrays); None off
    the card."""
    if device is None:
        return None
    return {"bytes": int(torch.cuda.memory_allocated(device)),
            "reservedBytes": int(torch.cuda.memory_reserved(device))}


def backend_memory_stats(device: torch.device | None) -> dict | None:
    """``torch.cuda.memory_stats`` of ``device``, its numeric entries;
    None off the card."""
    if device is None:
        return None
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items()
            if isinstance(v, (int, float))}


def compile_posture() -> dict:
    """Per-family compile posture: eager torch compiles no program per
    shape, so there is none to report."""
    return {}


def memory_ledger(engine, reset_hwm: bool = False) -> dict:
    """Everything this engine keeps resident: the state tables, host
    staging arenas and the archive's decoded-segment cache, with the
    allocator's view of the card. ``reset_hwm`` drains the high-watermarks
    (the scrape's "worst case since the last scrape"); peeks leave them."""
    eng = getattr(engine, "local", engine)
    comp: dict[str, int] = {}
    st = getattr(eng, "state", None)
    if st is not None:
        comp["ring_store"] = tree_nbytes(st.store)
        comp["registry"] = tree_nbytes(st.registry)
        comp["device_state"] = tree_nbytes(st.device_state)
        comp["pipeline_metrics"] = tree_nbytes(st.metrics)
        if st.windows is not None:
            comp["telemetry_windows"] = tree_nbytes(st.windows)
        if st.zones is not None:
            comp["geofence_zones"] = tree_nbytes(st.zones)
    pool = getattr(eng, "_arena_pool", None)
    if pool is not None:
        comp["arena_pool"] = int(pool.nbytes)
    arch = getattr(eng, "archive", None)
    cache = getattr(arch, "cache", None) if arch is not None else None
    if cache is not None:
        comp["segment_cache"] = int(cache.nbytes)
    hwm: dict[str, int] = {}
    if pool is not None:
        hwm["arena_occupancy"] = int(pool.take_occupancy_hwm(reset=reset_hwm))
    take_backlog = getattr(eng, "take_backlog_hwm", None)
    if take_backlog is not None:
        hwm["staged_backlog_rows"] = int(take_backlog(reset=reset_hwm))
    dev = _cuda_device(eng)
    return {
        "components": comp,
        "totalBytes": sum(comp.values()),
        "inflightPrograms": len(getattr(eng, "_pending_outs", ()) or ()),
        "highWatermarks": hwm,
        "liveArrays": live_array_stats(dev),
        "deviceMemoryStats": backend_memory_stats(dev),
    }


def device_memory_payload(engine) -> dict:
    """The ledger breakdown plus the per-family compile posture (a peek:
    high-watermarks are not reset; only the scrape drains them)."""
    return {**memory_ledger(engine, reset_hwm=False),
            "compileFamilies": compile_posture()}


def export_devicewatch(engine, registry=None) -> None:
    """Scrape-time export: the per-engine memory ledger with
    reset-on-scrape high-watermarks, and the query-path flight records
    drained into the device execution-time histogram."""
    reg = registry or REGISTRY
    inst = devicewatch_metrics(reg)
    led = memory_ledger(engine, reset_hwm=True)
    lbl = getattr(engine, "metrics_label",
                  getattr(getattr(engine, "local", None), "metrics_label",
                          "e?"))
    mem = inst["mem"]
    written: set[tuple] = set()
    for comp, nbytes in led["components"].items():
        mem.set(nbytes, component=comp, engine=lbl)
        written.add(tuple(sorted({"component": comp,
                                  "engine": lbl}.items())))
    la = led["liveArrays"]
    if la is not None:
        mem.set(la["bytes"], component="live_arrays", engine=lbl)
        written.add(tuple(sorted({"component": "live_arrays",
                                  "engine": lbl}.items())))
    mem.retain(written, engine=lbl)
    mh = inst["mem_hwm"]
    kept: set[tuple] = set()
    for comp, v in led["highWatermarks"].items():
        mh.set(v, component=comp, engine=lbl)
        kept.add(tuple(sorted({"component": comp, "engine": lbl}.items())))
    mh.retain(kept, engine=lbl)
    # query-path device time: drain completed query lifecycles (the
    # ingest drain lives in metrics.harvest_slo, on the shared
    # consume-once records)
    flight = getattr(engine, "flight", None)
    if flight is not None:
        exec_hist = inst["exec"]
        for rec in flight.harvest_completed("query", terminal="device"):
            t0 = rec.stages.get("lookup", rec.t0_ns)
            t1 = rec.stages["device"]
            if t1 >= t0:
                exec_hist.observe((t1 - t0) / 1e9, family="query")


_PROFILE_LOCK = threading.Lock()
_PROFILE_SEQ = [0]


def capture_device_profile(ms: float, base_dir: str | None = None) -> dict:
    """Capture a ``torch.profiler`` trace of ~``ms`` milliseconds (host,
    and the card on a CUDA build) into a fresh named directory as a
    Chrome trace, and return its location and file listing. The profiler
    is a process singleton, so captures serialize on a lock; ``ms``
    clamps to [50, 10000]."""
    from sitewhere_tpu_torch.utils.tracing import device_trace

    ms = max(50.0, min(float(ms), 10_000.0))
    base = base_dir or os.path.join(tempfile.gettempdir(),
                                    "swtpu-device-profiles")
    os.makedirs(base, exist_ok=True)
    with _PROFILE_LOCK:
        _PROFILE_SEQ[0] += 1
        out = os.path.join(
            base, time.strftime("prof-%Y%m%d-%H%M%S")
            + f"-p{os.getpid()}-{_PROFILE_SEQ[0]}")
        with device_trace(out):
            time.sleep(ms / 1000.0)
    files = []
    total = 0
    for root, _dirs, names in os.walk(out):
        for name in names:
            p = os.path.join(root, name)
            try:
                total += os.path.getsize(p)
            except OSError:
                continue
            files.append(os.path.relpath(p, out))
    return {"dir": out, "ms": ms, "files": sorted(files), "bytes": total}
