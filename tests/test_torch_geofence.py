"""Parity of the port's geofence test with ``sitewhere_tpu.ops.geofence``:
``pack_zones`` (layout and errors), ``points_in_zones`` on seeded points
kept off every edge by a margin (convex, concave and padded polygons), and
the fused step with zones installed — the ``geofence_hit`` lane of
``tenant_counters`` and every other leaf byte-identical to the JAX step's
over a multi-batch stream."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.events import EventBatch as JaxBatch
from sitewhere_tpu.ops import geofence as jgeo
from sitewhere_tpu.pipeline import PipelineConfig as JaxConfig
from sitewhere_tpu.pipeline import PipelineState as JaxState
from sitewhere_tpu.pipeline import ZoneTable as JaxZones
from sitewhere_tpu.pipeline import make_pipeline_step
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.core.events import EventBatch
from sitewhere_tpu_torch.ops import geofence as tgeo
from sitewhere_tpu_torch.pipeline import PipelineConfig, pipeline_step
from tests.torch_parity import assert_leaf_equal, assert_tree_equal, make_batch

SQUARE = [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)]
TRIANGLE = [(-1.5, -1.5), (-0.5, -1.0), (-1.5, -0.25)]
CONCAVE = [(0.0, -2.0), (1.0, -2.0), (1.0, -1.0), (0.5, -1.5), (0.0, -1.0)]
ZONES = [SQUARE, TRIANGLE, CONCAVE]


def _edge_distance(p, poly) -> float:
    """Least distance from point p to any edge of poly."""
    best = np.inf
    a = np.asarray(poly, np.float64)
    b = np.roll(a, -1, axis=0)
    for (ay, ax), (by, bx) in zip(a, b):
        d = np.array([by - ay, bx - ax])
        t = np.clip(np.dot(np.array([p[0] - ay, p[1] - ax]), d) / np.dot(d, d), 0, 1)
        best = min(best, np.hypot(p[0] - (ay + t * d[0]), p[1] - (ax + t * d[1])))
    return best


def off_edge_points(rng, n, zones, margin=1e-3, lo=-2.5, hi=1.5):
    pts = rng.uniform(lo, hi, (4 * n, 2)).astype(np.float32)
    keep = [p for p in pts if min(_edge_distance(p, z) for z in zones) > margin]
    return np.asarray(keep[:n], np.float32)


def test_pack_zones_matches_jax():
    for zones, cap in ((ZONES, 8), ([SQUARE], 4), ([], 16)):
        for a, b in zip(jgeo.pack_zones(zones, cap), tgeo.pack_zones(zones, cap)):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype
    with pytest.raises(ValueError, match=">= 3 vertices"):
        tgeo.pack_zones([[(0, 0), (1, 1)]])
    with pytest.raises(ValueError, match="> capacity"):
        tgeo.pack_zones([[(0, 0)] * 20], max_vertices=8)


@pytest.mark.parametrize("seed,cap", [(0, 8), (1, 16), (2, 5)])
def test_points_in_zones_matches_jax(seed, cap):
    rng = np.random.default_rng(seed)
    pts = off_edge_points(rng, 400, ZONES)
    verts, valid = tgeo.pack_zones(ZONES, cap)
    valid[1] = seed != 1          # an invalid zone never contains anything
    ref = jgeo.points_in_zones(jnp.asarray(pts), jnp.asarray(verts),
                               jnp.asarray(valid))
    got = tgeo.points_in_zones(torch.from_numpy(pts), torch.from_numpy(verts),
                               torch.from_numpy(valid))
    assert_leaf_equal(ref, got, "inside")
    assert got.any() and not got.all()


B, C, W = 48, 4, 8
N_TOKENS, TOKEN_CAP = 28, 32


@pytest.mark.parametrize("seed", [3, 4])
def test_pipeline_step_with_zones_matches_jax(seed):
    verts, valid = tgeo.pack_zones(ZONES, 8)
    jstate = JaxState.create(device_capacity=20, token_capacity=TOKEN_CAP,
                             assignment_capacity=24, store_capacity=256,
                             channels=C)
    jstate = dataclasses.replace(jstate, zones=JaxZones(jnp.asarray(verts),
                                                        jnp.asarray(valid)))
    tstate = convert.pipeline_state_from_numpy(jax.device_get(jstate), "cpu")
    assert_tree_equal(jstate, tstate)
    jstep = make_pipeline_step(JaxConfig())
    rng = np.random.default_rng(seed)
    for k in range(6):
        cols = make_batch(rng, B, C, N_TOKENS, TOKEN_CAP, W, ts0=100 * k)
        cols["values"][:, :2] = rng.uniform(-2.5, 1.5, (B, 2)).astype(np.float32)
        jstate, _ = jstep(jstate, JaxBatch(**cols))
        tstate, _ = pipeline_step(tstate, EventBatch.from_numpy("cpu", **cols),
                                  PipelineConfig())
        assert_tree_equal(jstate, tstate, f"batch {k} state")
    hits = tstate.metrics.tenant_counters[:, 2]
    assert int(hits.sum()) > 0          # the lane counted zone hits
