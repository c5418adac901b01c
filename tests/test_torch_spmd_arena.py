"""The port's multi-shard engine on its stacked-arena batch path: the
arena × ``scan_chunk`` × depth matrix byte-identical to the per-row router
(``arena=False``) and, at the matrix's light cells, to the JAX engine's
arena path; query pages and metrics equal to a single-card engine's; the
conservation ledger balanced; a ``scan_chunk`` retune mid-stream; and QoS
shedding then recovering with nothing lost, as in ``tests/test_spmd.py``."""

import pytest

from sitewhere_tpu.utils.qos import AdmissionController as JaxAdmission
from sitewhere_tpu.utils.qos import ManualClock as JaxClock
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from sitewhere_tpu_torch.utils.qos import AdmissionController, ManualClock
from tests.torch_spmd import (_meas, _stream, assert_state_equal, jax_spmd, page, run,
                              settle, torch_single, torch_spmd)

_MATRIX = [(n, k, d) for n in (1, 2, 4) for k in (1, 2) for d in (1, 2)]
_JAX_CELLS = [(2, 1, 1), (2, 2, 2)]


def _store_equal(a, b):
    sa, sb = a.state.store, b.state.store
    for f in ("valid", "etype", "device", "assignment", "tenant", "ts_ms",
              "received_ms", "values", "vmask", "aux", "cursor", "epoch"):
        assert getattr(sa, f).equal(getattr(sb, f)), f


@pytest.mark.parametrize("n_shards,scan_chunk,depth", _MATRIX,
                         ids=[f"{n}s-k{k}-d{d}" for n, k, d in _MATRIX])
def test_arena_matrix_byte_identity_and_parity(n_shards, scan_chunk, depth):
    arena = torch_spmd(n_shards, scan_chunk, depth)
    router = torch_spmd(n_shards, arena=False)
    ref = torch_single()
    events = _stream()
    run([arena, router, ref], events)
    settle(arena, router, ref)
    _store_equal(arena, router)
    assert arena.host_counters.get("staged_copy_rows", 0) == 0
    assert arena.host_counters.get("arena_rows", 0) == len(events)
    for kw in (dict(limit=200), dict(limit=7), dict(device_token="sp-3", limit=20)):
        assert page(ref, **kw) == page(arena, **kw), kw
    a, b = arena.metrics(), router.metrics()
    for k in ("processed", "found", "missed", "registered", "persisted",
              "reg_overflow", "channel_collisions", "staged"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert check_conservation(build_ledger(arena)) == []
    assert check_conservation(build_ledger(router)) == []


@pytest.fixture(scope="module", params=_JAX_CELLS,
                ids=[f"{n}s-k{k}-d{d}" for n, k, d in _JAX_CELLS])
def jax_cell(request):
    n, k, d = request.param
    jeng, teng = jax_spmd(n, k, d), torch_spmd(n, k, d)
    run([jeng, teng], _stream())
    settle(jeng, teng)
    return jeng, teng


def test_arena_cell_state_byte_identical_to_jax(jax_cell):
    jeng, teng = jax_cell
    assert_state_equal(jeng, teng)
    assert teng.host_counters == jeng.host_counters


def test_arena_cell_metrics_and_shard_flow_match_jax(jax_cell):
    jeng, teng = jax_cell
    a, b = jeng.metrics(), teng.metrics()
    for k in ("processed", "found", "missed", "registered", "persisted",
              "staged", "arena_rows", "arena_pool_size"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert teng.shard_flow() == jeng.shard_flow()
    assert page(jeng, canonical=False, limit=200) == page(teng, canonical=False, limit=200)


def test_arena_tie_order_matches_router():
    arena, router = torch_spmd(2, 1, 1), torch_spmd(2, arena=False)
    run([arena, router], _stream(ties=True))
    assert page(arena, limit=200) == page(router, limit=200)


def test_arena_scan_chunk_retune_stays_byte_identical():
    arena, router = torch_spmd(2, scan_chunk=1, depth=2), torch_spmd(2, arena=False)
    jrouter = jax_spmd(2, arena=False)
    events = _stream()
    half = len(events) // 2
    run([arena, router, jrouter], events[:half])
    assert arena.set_ingest_tuning(scan_chunk=2)["scan_chunk"] == 2
    assert arena._arena_step is not None and arena._arena_pool._free[0].lanes == 2
    run([arena, router, jrouter], events[half:])
    settle(arena, router, jrouter)
    _store_equal(arena, router)
    assert_state_equal(jrouter, arena, parts=("store",))


def _shed_cycle(eng, clk):
    frames = [[_meas(f"sp-{j}", 20.0 + i, 1_000 + i * 10 + j) for j in range(10)]
              for i in range(12)]
    admitted = sheds = rounds = 0
    backlog = list(frames)
    while backlog and rounds < 100:
        rounds += 1
        still = []
        for f in backlog:
            if eng.qos.admit("sr-t", len(f)).admitted:
                eng.ingest_json_batch(f, "sr-t")
                admitted += len(f)
            else:
                sheds += 1
                still.append(f)
        backlog = still
        clk.advance(0.5)
    eng.flush()
    return admitted, sheds, rounds, backlog


def test_qos_shed_then_recover_no_loss_as_in_jax():
    """Per-tenant admission at the ingest edge: a flood sheds, the client
    retries after the clock advances, and afterwards every admitted event
    was accepted once. The same decisions as the JAX engine's."""
    teng, jeng = torch_spmd(2, scan_chunk=2, depth=2, qos=True), \
        jax_spmd(2, scan_chunk=2, depth=2, qos=True)
    clk, jclk = ManualClock(), JaxClock()
    teng.qos = AdmissionController(tenant_rates={"sr-t": 40.0}, burst_s=1.0, clock=clk)
    jeng.qos = JaxAdmission(tenant_rates={"sr-t": 40.0}, burst_s=1.0, clock=jclk)
    got = _shed_cycle(teng, clk)
    assert got == _shed_cycle(jeng, jclk)
    admitted, sheds, _, backlog = got
    assert not backlog and sheds > 0 and admitted == 120
    counters = teng.tenant_pipeline_counters().get("sr-t", {})
    assert counters.get("accepted") == 120
    assert counters.get("dedup_dropped", 0) == 0
    assert teng.host_counters.get("staged_copy_rows", 0) == 0
    assert check_conservation(build_ledger(teng)) == []



def test_native_decoder_path_equals_the_python_path():
    """The native scanner (the card's path) scatters into the shard lanes
    exactly as the Python decode does (the JAX tests' path)."""
    native = torch_spmd(2, scan_chunk=2, depth=2, use_native=True)
    python = torch_spmd(2, scan_chunk=2, depth=2)
    run([native, python], _stream())
    settle(native, python)
    assert native._native_decoder is not None and python._native_decoder is None
    _store_equal(native, python)
    assert page(native, canonical=False, limit=200) == page(python, canonical=False, limit=200)
    assert native.host_counters == python.host_counters
    assert native.shard_flow() == python.shard_flow()
