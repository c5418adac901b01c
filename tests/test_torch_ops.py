"""Parity of the port's pipeline ops with the JAX ops, one op at a time, on
seeded inputs made with numpy and handed to both sides. Int and bool
outputs must be byte-identical; float outputs equal (the ops only copy
floats)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.registry import RegistryTables as JaxRegistry
from sitewhere_tpu.core.state import DeviceStateStore as JaxDeviceState
from sitewhere_tpu.core.store import EventStore as JaxStore
from sitewhere_tpu.models import windows as jwin
from sitewhere_tpu.ops import lookup as jlookup
from sitewhere_tpu.ops import persist as jpersist
from sitewhere_tpu.ops import registration as jreg
from sitewhere_tpu.ops import window as jwindow
from sitewhere_tpu_torch.core.registry import MAX_ACTIVE_ASSIGNMENTS, RegistryTables
from sitewhere_tpu_torch.core.state import DeviceStateStore
from sitewhere_tpu_torch.core.store import EventStore
from sitewhere_tpu_torch.models import windows as twin
from sitewhere_tpu_torch.ops import lookup as tlookup
from sitewhere_tpu_torch.ops import persist as tpersist
from sitewhere_tpu_torch.ops import registration as treg
from sitewhere_tpu_torch.ops import window as twindow
from tests.torch_parity import INT32_MIN, assert_leaf_equal, assert_tree_equal

N_DEV, N_TOK, N_ASN = 24, 40, 48


def _both(cls_jax, cls_torch, cols):
    return (cls_jax(**{k: jnp.asarray(v) for k, v in cols.items()}),
            cls_torch(**{k: torch.from_numpy(np.array(v)) for k, v in cols.items()}))


def _registry_cols(rng):
    """A populated registry: tokens mapped to devices (some inactive, some
    of another tenant), devices with 0-4 assignment slots, some of those
    assignments released."""
    a = MAX_ACTIVE_ASSIGNMENTS
    t2d = np.full(N_TOK, -1, np.int32)
    mapped = rng.choice(N_TOK, 30, replace=False)
    t2d[mapped] = rng.permutation(N_DEV)[np.arange(30) % N_DEV]
    slots = np.where(rng.random((N_DEV, a)) < 0.5,
                     rng.integers(0, N_ASN, (N_DEV, a)), -1).astype(np.int32)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return dict(
        token_to_device=t2d,
        device_active=rng.random(N_DEV) < 0.85,
        device_type=i32(rng.integers(0, 3, N_DEV)),
        device_tenant=i32(rng.integers(-1, 3, N_DEV)),
        device_area=i32(rng.integers(-1, 5, N_DEV)),
        device_customer=i32(rng.integers(-1, 5, N_DEV)),
        device_parent=np.full(N_DEV, -1, np.int32),
        device_assignments=slots,
        assignment_active=rng.random(N_ASN) < 0.8,
        assignment_status=i32(rng.integers(0, 3, N_ASN)),
        assignment_device=i32(rng.integers(-1, N_DEV, N_ASN)),
        assignment_asset=i32(rng.integers(-1, 9, N_ASN)),
        assignment_area=i32(rng.integers(-1, 9, N_ASN)),
        assignment_customer=i32(rng.integers(-1, 9, N_ASN)),
    )


def _tokens(rng, b):
    tok = rng.integers(-3, N_TOK + 4, b).astype(np.int32)   # OOR both ways
    tenant = rng.integers(-1, 3, b).astype(np.int32)
    valid = rng.random(b) < 0.9
    return tok, tenant, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_and_expand_match_jax(seed):
    rng = np.random.default_rng(seed)
    jr, tr = _both(JaxRegistry, RegistryTables, _registry_cols(rng))
    tok, tenant, valid = _tokens(rng, 96)
    jres = jlookup.lookup_devices(jr, jnp.asarray(tok), jnp.asarray(tenant),
                                  jnp.asarray(valid))
    tres = tlookup.lookup_devices(tr, torch.from_numpy(tok),
                                  torch.from_numpy(tenant), torch.from_numpy(valid))
    for f in jres._fields:
        assert_leaf_equal(getattr(jres, f), getattr(tres, f), f"lookup.{f}")
    assert int(tres.n_assignments.max()) >= 2       # multi-assignment rows
    jexp = jlookup.expand_assignments(jr, jres)
    texp = tlookup.expand_assignments(tr, tres)
    for f in jexp._fields:
        assert_leaf_equal(getattr(jexp, f), getattr(texp, f), f"expand.{f}")


@pytest.mark.parametrize("next_device,next_assignment", [
    (0, 0),        # empty tables
    (20, 10),      # device rows run out mid-batch -> overflow
    (5, 46),       # assignment rows run out first
])
def test_register_misses_matches_jax(next_device, next_assignment):
    rng = np.random.default_rng(next_device + next_assignment)
    cols = _registry_cols(rng)
    cols["token_to_device"][:] = -1            # every token unregistered
    jr, tr = _both(JaxRegistry, RegistryTables, cols)
    tok, tenant, valid = _tokens(rng, 64)
    miss = valid & (rng.random(64) < 0.9)
    jout = jreg.register_misses(
        jr, jnp.int32(next_device), jnp.int32(next_assignment),
        jnp.asarray(tok), jnp.asarray(tenant), jnp.asarray(miss),
        jnp.int32(0), jnp.int32(-1), jnp.int32(7))
    tout = treg.register_misses(
        tr, torch.tensor(next_device, dtype=torch.int32),
        torch.tensor(next_assignment, dtype=torch.int32),
        torch.from_numpy(tok), torch.from_numpy(tenant), torch.from_numpy(miss),
        0, -1, 7)
    assert_tree_equal(jout.registry, tout.registry, "registry")
    for f in ("next_device", "next_assignment", "n_registered", "new_tokens",
              "overflow"):
        assert_leaf_equal(getattr(jout, f), getattr(tout, f), f)
    assert int(tout.n_registered) > 0
    if next_device + next_assignment:
        assert bool(tout.overflow)


def _rows(rng, e, c, n_tenants=8):
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return dict(
        valid=rng.random(e) < 0.7,
        etype=i32(rng.integers(0, 6, e)),
        device=i32(rng.integers(-1, N_DEV, e)),
        assignment=i32(rng.integers(-1, N_ASN, e)),
        tenant=i32(rng.integers(-2, n_tenants, e)),
        area=i32(rng.integers(-1, 5, e)),
        customer=i32(rng.integers(-1, 5, e)),
        asset=i32(rng.integers(-1, 5, e)),
        ts_ms=i32(rng.integers(0, 1000, e)),
        received_ms=i32(rng.integers(0, 1000, e)),
        values=rng.standard_normal((e, c)).astype(np.float32),
        vmask=rng.random((e, c)) < 0.5,
        aux=i32(rng.integers(-1, 9, (e, 2))),
    )


@pytest.mark.parametrize("arenas", [1, 4])
def test_append_events_matches_jax_through_ring_wrap(arenas):
    rng = np.random.default_rng(arenas)
    cap, c, e = 64 * arenas, 3, 48
    js = JaxStore.zeros(cap, c, arenas)
    ts = EventStore.zeros(cap, c, arenas, device="cpu")
    for k in range(16):      # ~34 valid rows a step wrap every 64-row arena
        rows = _rows(rng, e, c)
        jres = jpersist.append_events(js, **{k2: jnp.asarray(v) for k2, v in rows.items()})
        tres = tpersist.append_events(ts, **{k2: torch.from_numpy(v) for k2, v in rows.items()})
        js, ts = jres.store, tres.store
        assert_tree_equal(js, ts, f"append {k}")
        assert_leaf_equal(jres.appended, tres.appended, f"appended {k}")
    assert int(ts.epoch.min()) >= 1                 # every arena wrapped


def test_append_events_refuses_batch_larger_than_arena():
    rng = np.random.default_rng(0)
    rows = _rows(rng, 40, 2)
    with pytest.raises(ValueError, match="exceeds per-arena"):
        jpersist.append_events(JaxStore.zeros(64, 2, 2),
                               **{k: jnp.asarray(v) for k, v in rows.items()})
    with pytest.raises(ValueError, match="exceeds per-arena"):
        tpersist.append_events(EventStore.zeros(64, 2, 2, device="cpu"),
                               **{k: torch.from_numpy(v) for k, v in rows.items()})


def _merge_batch(rng, b, c, n_dev):
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    found = rng.random(b) < 0.85
    ts = i32(rng.integers(0, 6, b))           # many duplicate timestamps
    ts[rng.random(b) < 0.05] = INT32_MIN
    ts[rng.random(b) < 0.05] = INT32_MIN + 1
    values = rng.standard_normal((b, c)).astype(np.float32)
    etype = i32(rng.integers(-1, 7, b))       # includes out-of-range types
    values[etype == 2, 0] = rng.integers(0, 4, int(np.sum(etype == 2)))
    return dict(
        dev=np.where(found, rng.integers(0, n_dev, b), -1).astype(np.int32),
        found=found, etype=etype, ts_ms=ts,
        seq=np.arange(b, dtype=np.int32), values=values,
        vmask=rng.random((b, c)) < 0.7,
        aux=i32(rng.integers(-1, 5, (b, 2))),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_batch_state_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_dev, c = 10, 4
    js = JaxDeviceState.zeros(n_dev, c)
    ts = DeviceStateStore.zeros(n_dev, c, device="cpu")
    for k in range(5):
        cols = _merge_batch(rng, 80, c, n_dev)
        js = jwindow.merge_batch_state(js, **{k2: jnp.asarray(v) for k2, v in cols.items()})
        ts = twindow.merge_batch_state(ts, **{k2: torch.from_numpy(v) for k2, v in cols.items()})
        assert_tree_equal(js, ts, f"merge {k}")
    assert bool(ts.recent_meas_valid.all(1).any())   # some ring filled


def test_presence_write_of_many_rows_of_one_device_matches_jax():
    """Many rows of one device in one batch (every row of it but one, and
    rows that did not resolve) mark it PRESENT through a scatter-min with a
    defined winner; the state equals the JAX merge's, MISSING devices
    included."""
    from sitewhere_tpu.core.types import PresenceState as JaxPresence
    from sitewhere_tpu_torch.core.types import PresenceState

    assert int(PresenceState.PRESENT) == min(int(v) for v in PresenceState)
    assert int(PresenceState.PRESENT) == int(JaxPresence.PRESENT)
    rng = np.random.default_rng(9)
    n_dev, c, b = 6, 4, 200
    js = JaxDeviceState.zeros(n_dev, c)
    ts = DeviceStateStore.zeros(n_dev, c, device="cpu")
    missing = np.full(n_dev, int(PresenceState.MISSING), np.int32)
    js = dataclasses.replace(js, presence=jnp.asarray(missing))
    ts = dataclasses.replace(ts, presence=torch.from_numpy(missing.copy()))
    cols = _merge_batch(rng, b, c, n_dev)
    cols["dev"] = np.where(np.arange(b) % 40 == 0, 4, 2).astype(np.int32)
    cols["found"] = np.arange(b) % 7 != 3
    cols["etype"] = np.full(b, 5, np.int32)
    js = jwindow.merge_batch_state(js, **{k: jnp.asarray(v) for k, v in cols.items()})
    ts = twindow.merge_batch_state(ts, **{k: torch.from_numpy(v) for k, v in cols.items()})
    assert_tree_equal(js, ts, "presence")
    assert ts.presence.tolist() == [1, 1, 0, 1, 0, 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_append_measurements_and_snapshot_match_jax(seed):
    rng = np.random.default_rng(seed)
    m, w, c, b = 6, 8, 3, 40
    jw = jwin.TelemetryWindows.zeros(m, w, c)
    tw = twin.TelemetryWindows.zeros(m, w, c, device="cpu")
    for k in range(10):
        dev = rng.integers(-1, m + 3, b).astype(np.int32)   # some past M
        etype = rng.integers(0, 3, b).astype(np.int32)
        # at most W measurement rows of one device per batch (see
        # models/windows.append_measurements)
        for d in np.unique(dev):
            etype[np.nonzero((dev == d) & (etype == 0))[0][w:]] = 1
        cols = dict(dev=dev, found=rng.random(b) < 0.9, etype=etype,
                    ts_ms=rng.integers(0, 5, b).astype(np.int32),
                    seq=np.arange(b, dtype=np.int32),
                    values=rng.standard_normal((b, c)).astype(np.float32))
        jw = jwin.append_measurements(jw, **{k2: jnp.asarray(v) for k2, v in cols.items()})
        tw = twin.append_measurements(tw, **{k2: torch.from_numpy(v) for k2, v in cols.items()})
        assert_tree_equal(jw, tw, f"windows {k}")
        assert_leaf_equal(jwin.snapshot_windows(jw), twin.snapshot_windows(tw),
                          f"snapshot {k}")
    assert int(tw.filled.max()) > w                      # rings wrapped


def test_window_ring_order_matches_jax_example():
    """The JAX package's own ring example (tests/test_models.py): two
    batches of 5 and 6 rows for one device wrap an 8-slot ring in order."""
    rng = np.random.default_rng(0)
    vals = rng.random((11, 3)).astype(np.float32)
    tw = twin.TelemetryWindows.zeros(4, 8, 3, device="cpu")
    for lo, hi, t0 in ((0, 5, 0), (5, 11, 100)):
        n = hi - lo
        tw = twin.append_measurements(
            tw, dev=torch.full((n,), 1, dtype=torch.int32),
            found=torch.ones(n, dtype=torch.bool),
            etype=torch.zeros(n, dtype=torch.int32),
            ts_ms=torch.arange(t0, t0 + n, dtype=torch.int32),
            seq=torch.arange(n, dtype=torch.int32),
            values=torch.from_numpy(vals[lo:hi]))
    assert int(tw.filled[1]) == 11
    np.testing.assert_array_equal(twin.snapshot_windows(tw)[1].numpy(), vals[-8:])


def test_dataclass_fields_match_jax():
    """The port's state dataclasses carry exactly the JAX fields."""
    for jcls, tcls in ((JaxRegistry, RegistryTables), (JaxStore, EventStore),
                       (JaxDeviceState, DeviceStateStore),
                       (jwin.TelemetryWindows, twin.TelemetryWindows)):
        assert ([f.name for f in dataclasses.fields(jcls)]
                == [f.name for f in dataclasses.fields(tcls)]), tcls.__name__
