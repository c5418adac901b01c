"""Zone geofencing: vectorized point-in-polygon on the device (port of
``sitewhere_tpu/ops/geofence.py``).

Every location event in a batch is tested against every zone in one
[N x Z x V] ray-casting pass — no per-event host loops.

Zone storage is padded to a static vertex capacity V by repeating the
first vertex: the wrap edge then degenerates to a zero-length segment that
contributes no crossings, so polygons of any size share one shape.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_zones(polygons: list[list[tuple[float, float]]],
               max_vertices: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """[(lat, lon), ...] polygons -> (verts [Z, V, 2] float32, valid [Z]).
    Polygons beyond ``max_vertices`` raise; an empty list packs a single
    invalid row so downstream shapes stay static."""
    z = max(1, len(polygons))
    verts = np.zeros((z, max_vertices, 2), np.float32)
    valid = np.zeros(z, bool)
    for i, poly in enumerate(polygons):
        if len(poly) < 3:
            raise ValueError(f"zone {i}: a polygon needs >= 3 vertices")
        if len(poly) > max_vertices:
            raise ValueError(
                f"zone {i}: {len(poly)} vertices > capacity {max_vertices}")
        arr = np.asarray(poly, np.float32)
        verts[i, :len(poly)] = arr
        verts[i, len(poly):] = arr[0]      # pad = first vertex (degenerate)
        valid[i] = True
    return verts, valid


def points_in_zones(points: torch.Tensor, verts: torch.Tensor,
                    zone_valid: torch.Tensor) -> torch.Tensor:
    """points [N, 2] (lat, lon) x zones [Z, V, 2] -> bool [N, Z].

    Even-odd ray casting; the ray runs in +lon. Division-free edge test so
    degenerate (padded) edges are exact no-ops. Each side of the edge
    test is one float32 product of two differences, so no fused
    multiply-add can round it differently from the JAX package."""
    a = verts                                   # [Z, V, 2]
    b = torch.roll(verts, -1, dims=1)           # [Z, V, 2] next vertex
    py = points[:, None, None, 0]               # lat  [N, 1, 1]
    px = points[:, None, None, 1]               # lon  [N, 1, 1]
    ay, ax = a[None, :, :, 0], a[None, :, :, 1]   # [1, Z, V]
    by, bx = b[None, :, :, 0], b[None, :, :, 1]

    straddles = (ay > py) != (by > py)
    # px < ax + (py - ay) * (bx - ax) / (by - ay), multiplied through by
    # (by - ay) with sign-aware flip:
    lhs = (px - ax) * (by - ay)
    rhs = (bx - ax) * (py - ay)
    crosses = straddles & torch.where(by > ay, lhs < rhs, lhs > rhs)
    inside = crosses.sum(2) % 2 == 1            # [N, Z]
    return inside & zone_valid[None, :]
