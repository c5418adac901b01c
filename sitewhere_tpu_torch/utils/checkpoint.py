"""Checkpoint and recovery: durable snapshots of the engine (port of
``sitewhere_tpu/utils/checkpoint.py``).

One snapshot captures the whole engine — registry tables, device-state
store, event ring, allocation counters, metrics — plus the host mirrors
(interners, device metadata, epoch base). Paired with the write-ahead log
(``utils/ingestlog.py``) it gives at-least-once resume: restore the
snapshot, replay the log past the snapshot's store cursor, and the state
converges to the one before the crash.

The snapshot format is the JAX package's: ``state.npz`` holds one array per
state leaf under its JAX ``keystr`` path (``.registry.token_to_device``,
...), so a snapshot written by either package restores into the other's
engine (the port's through ``convert.pipeline_state_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import types

import numpy as np
import torch

from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.compat import DEFAULT_DEVICE
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import (WAL_JSON, AssignmentInfo, DeviceInfo,
                                        Engine, EngineConfig)
from sitewhere_tpu_torch.ops.readback import absolute_cursor

def _leaves(obj, prefix: str = ""):
    """(keystr path, tensor) of every tensor leaf of a state dataclass,
    in field order; None subtrees and static fields have none."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = f"{prefix}.{f.name}"
        if isinstance(v, torch.Tensor):
            yield path, v
        elif dataclasses.is_dataclass(v):
            yield from _leaves(v, path)


def _host_tree(obj, arrays, prefix: str = ""):
    """A namespace shaped like the state dataclass ``obj`` whose leaves
    are the snapshot's arrays under the same paths. A metrics counter the
    snapshot predates keeps ``obj``'s fresh zeros (counters start over
    rather than refusing to restore)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = f"{prefix}.{f.name}"
        if isinstance(v, torch.Tensor):
            if path.startswith(".metrics.") and path not in arrays:
                out[f.name] = v.cpu().numpy()
            else:
                out[f.name] = arrays[path]
        elif dataclasses.is_dataclass(v):
            out[f.name] = _host_tree(v, arrays, path)
        else:
            out[f.name] = v
    return types.SimpleNamespace(**out)


def _interned(interner) -> list[str]:
    return [interner.token(i) for i in range(len(interner))]


def save_engine(engine: Engine, directory: str | pathlib.Path) -> dict:
    """Write a full snapshot; returns the manifest. With a WAL, a
    watermark at the snapshot's store cursor is appended and synced:
    recovery replays only the records after it."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with engine.lock:
        # staged batches and pending outputs both land first, or the saved
        # mirrors would lag the saved device state
        engine._sync_mirrors()
        arrays = {path: leaf.cpu().numpy() for path, leaf in _leaves(engine.state)}
        np.savez_compressed(directory / "state.npz", **arrays)
        host = {
            "epoch_base_unix_s": engine.epoch.base_unix_s,
            "next_device": engine._next_device,
            "next_assignment": engine._next_assignment,
            "store_cursor": absolute_cursor(engine.state.store),
            "tokens": _interned(engine.tokens),
            "tenants": _interned(engine.tenants),
            "device_types": _interned(engine.device_types),
            "channel_names": _interned(engine.channel_map.names),
            "alert_types": _interned(engine.alert_types),
            "areas": _interned(engine.areas),
            "customers": _interned(engine.customers),
            "assets": _interned(engine.assets),
            "event_ids": _interned(engine.event_ids),
            "token_device": {str(k): v for k, v in engine.token_device.items()},
            "devices": {str(did): dataclasses.asdict(info)
                        for did, info in engine.devices.items()},
            "assignments": {str(aid): dataclasses.asdict(info)
                            for aid, info in engine.assignments.items()},
            "device_slots": {str(k): v for k, v in engine.device_slots.items()},
            "dead_letters": engine.dead_letters[-4096:],
            "config": dataclasses.asdict(engine.config),
        }
        (directory / "host.json").write_text(json.dumps(host))
        manifest = {"format": 1, "arrays": len(arrays),
                    "devices": len(engine.devices),
                    "store_cursor": host["store_cursor"]}
        (directory / "manifest.json").write_text(json.dumps(manifest))
        if engine.wal is not None:
            engine.wal.append_watermark(host["store_cursor"])
            engine.wal.sync()
        return manifest


def _config_from(saved: dict) -> EngineConfig:
    """The port's EngineConfig from a snapshot's config (either package's):
    every key the port knows, with its value — fair tenancy, QoS, the
    autotuner and the observability switches included; a key it does not
    know is named in a warning and dropped."""
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(saved) - known)
    if unknown:
        logging.getLogger(__name__).warning(
            "snapshot config keys the port does not know, dropped: %s", unknown)
    return EngineConfig(**{k: v for k, v in saved.items() if k in known})


def restore_engine(directory: str | pathlib.Path,
                   device: str | torch.device = DEFAULT_DEVICE,
                   epoch_cls: type[EpochBase] = EpochBase) -> Engine:
    """Reconstruct an engine on ``device`` from a snapshot directory (one
    the port or the JAX package wrote). The engine's clock is
    ``epoch_cls`` at the snapshot's epoch base. Zones and rules are not
    part of a snapshot: install them again after the restore."""
    directory = pathlib.Path(directory)
    host = json.loads((directory / "host.json").read_text())
    engine = Engine(_config_from(host["config"]), device=device)
    engine.epoch = epoch_cls(host["epoch_base_unix_s"])
    with np.load(directory / "state.npz") as data:
        arrays = {k: data[k] for k in data.files}
    engine.state = convert.pipeline_state_from_numpy(
        _host_tree(engine.state, arrays), engine.device)

    for name, interner in (("tokens", engine.tokens),
                           ("tenants", engine.tenants),
                           ("device_types", engine.device_types),
                           ("channel_names", engine.channel_map.names),
                           ("alert_types", engine.alert_types),
                           ("areas", engine.areas),
                           ("customers", engine.customers),
                           ("assets", engine.assets),
                           ("event_ids", engine.event_ids)):
        for tok in host.get(name, []):
            interner.intern(tok)
    engine.token_device = {int(k): v for k, v in host["token_device"].items()}
    engine.devices = {int(k): DeviceInfo(**v) for k, v in host["devices"].items()}
    engine.assignments = {int(k): AssignmentInfo(**v)
                          for k, v in host.get("assignments", {}).items()}
    engine.assignment_tokens = {info.token: aid
                                for aid, info in engine.assignments.items()}
    engine.device_slots = {int(k): list(v)
                           for k, v in host.get("device_slots", {}).items()}
    engine._next_device = host["next_device"]
    engine._next_assignment = host["next_assignment"]
    engine.dead_letters = list(host["dead_letters"])
    # the restored device counters carry history this process never
    # staged: rebase before any replay, so the ledger balances over the
    # replayed rows
    engine.ledger.rebase(engine)
    return engine


def replay_records(wal, ingest_json, ingest_binary,
                   after_cursor: int = -1, run_cap: int = 4096) -> int:
    """Group a WAL's records into runs of one (wire format, tenant) and
    feed each run through the matching batch-ingest callable — the one
    place that parses the record framing of ``Engine._wal_append`` (tag
    byte + tenant + NUL + payload). Returns the records replayed."""
    count = 0
    run_key: tuple | None = None
    run: list[bytes] = []

    def flush_run():
        nonlocal run
        if not run:
            return
        tag, tenant = run_key
        if tag == WAL_JSON:
            ingest_json(run, tenant=tenant)
        else:
            ingest_binary(run, tenant=tenant)
        run = []

    for rec in wal.replay(after_cursor=after_cursor):
        tag = rec[:1]
        sep = rec.index(b"\x00", 1)
        key = (tag, rec[1:sep].decode())
        if key != run_key or len(run) >= run_cap:
            flush_run()
            run_key = key
        run.append(rec[sep + 1:])
        count += 1
    flush_run()
    return count


def replay_wal_into(engine: Engine, after_cursor: int,
                    wal_dir: str | pathlib.Path | None) -> None:
    """Replay a WAL into ``engine`` through the ingest path that first
    accepted each record, then flush. ``wal_dir`` names the log to replay
    when it is not the engine's own (a copy on a recovery host: opened
    read-only, so it stays byte-identical). The engine's own WAL is
    detached during the replay (nothing is logged twice) and re-attached
    after it."""
    from sitewhere_tpu_torch.utils.ingestlog import IngestLog

    live_wal, engine.wal = engine.wal, None
    foreign = wal_dir is not None and (
        live_wal is None
        or pathlib.Path(wal_dir).resolve() != live_wal.dir.resolve())
    wal = IngestLog(wal_dir, readonly=True) if foreign else live_wal
    try:
        replay_records(wal, engine.ingest_json_batch,
                       engine.ingest_binary_batch, after_cursor=after_cursor)
        engine.flush()
    finally:
        if foreign:
            wal.close()
        engine.wal = live_wal
    if live_wal is None:
        logging.getLogger(__name__).warning(
            "WAL replay finished but the engine has no live WAL "
            "(config.wal_dir is None): new ingest will NOT be durable")


def recover_engine(snapshot_dir: str | pathlib.Path,
                   wal_dir: str | pathlib.Path | None = None,
                   device: str | torch.device = DEFAULT_DEVICE,
                   epoch_cls: type[EpochBase] = EpochBase) -> Engine:
    """Crash recovery: restore the snapshot, then replay the WAL past its
    watermark, each record through the wire format that first accepted
    it. The state converges to the one before the crash."""
    snapshot_dir = pathlib.Path(snapshot_dir)
    engine = restore_engine(snapshot_dir, device, epoch_cls)
    manifest = json.loads((snapshot_dir / "manifest.json").read_text())
    if wal_dir is not None or engine.config.wal_dir is not None:
        replay_wal_into(engine, manifest["store_cursor"], wal_dir)
    return engine
