"""Shared helpers for the parity tests between ``sitewhere_tpu`` (JAX, the
reference) and ``sitewhere_tpu_torch`` (the PyTorch port).

Inputs are made with numpy from a seed and handed to both sides; results
come back to numpy and are compared leaf by leaf. Integer and bool leaves
must be byte-identical; float leaves that the step only copies must be
equal too.
"""

from __future__ import annotations

import dataclasses

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
