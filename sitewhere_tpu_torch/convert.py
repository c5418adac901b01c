"""Carry weights and state from the JAX package's layouts into the port.

Every function takes plain numpy (or array-like) leaves and import nothing
of JAX: a caller pulls the JAX objects to the host first
(``jax.device_get``), so the port and the reference can start from the
same bytes.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.registry import RegistryTables
from sitewhere_tpu_torch.core.state import DeviceStateStore
from sitewhere_tpu_torch.core.store import EventStore
from sitewhere_tpu_torch.models.windows import TelemetryWindows
from sitewhere_tpu_torch.ops.rules import RollupBlock, RuleBlock, RulesState
from sitewhere_tpu_torch.pipeline import PipelineMetrics, PipelineState, ZoneTable

_AE_LAYERS = ("enc1", "enc2", "latent", "dec1", "dec2", "out")
_GATES = ("i", "f", "g", "o")


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def anomaly_params_from_flax(params) -> dict[str, torch.Tensor]:
    """A flax ``AnomalyModel`` parameter tree (numpy leaves; with or without
    the outer ``{"params": ...}``) -> the port's ``AnomalyModel``
    ``state_dict``. Flax ``Dense.kernel`` is [in, out]; ``nn.Linear`` keeps
    [out, in]. The LSTM cell's per-gate kernels ``ii/if/ig/io`` (no bias)
    and ``hi/hf/hg/ho`` (with bias) stack in gate order i, f, g, o."""
    p = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    for name in _AE_LAYERS:
        layer = p["ae"][name]
        out[f"ae.{name}.weight"] = _f32(layer["kernel"]).t().contiguous()
        out[f"ae.{name}.bias"] = _f32(layer["bias"])
    lstm = p["lstm"]
    cells = [k for k in lstm if k != "readout"]
    if len(cells) != 1:
        raise ValueError(f"expected one LSTM cell in the flax tree, got {cells}")
    cell = lstm[cells[0]]
    out["lstm.w_ih"] = torch.cat(
        [_f32(cell[f"i{g}"]["kernel"]).t() for g in _GATES]).contiguous()
    out["lstm.w_hh"] = torch.cat(
        [_f32(cell[f"h{g}"]["kernel"]).t() for g in _GATES]).contiguous()
    out["lstm.b_hh"] = torch.cat([_f32(cell[f"h{g}"]["bias"]) for g in _GATES])
    out["lstm.readout.weight"] = _f32(lstm["readout"]["kernel"]).t().contiguous()
    out["lstm.readout.bias"] = _f32(lstm["readout"]["bias"])
    return out


def adamw_state_from_optax(opt_state, model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer,
                           params_from=None) -> None:
    """Load an ``optax.adamw`` or ``optax.adam`` state (numpy leaves:
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), ...)``) into
    ``optimizer``, a torch AdamW or Adam over ``model``'s parameters:
    ``count`` -> ``step``, ``mu`` -> ``exp_avg``, ``nu`` ->
    ``exp_avg_sq``. The moments share the parameters' tree, so they map
    through the weights' own conversion, ``params_from``: by default
    :func:`anomaly_params_from_flax` (an ``AnomalyModel``; gate stacking and
    ``[out, in]`` transposes included), :func:`transformer_params_from_jax`
    for a ``TelemetryTransformer``. A JAX trainer that stopped after k
    steps then continues on the port where it stopped."""
    if params_from is None:
        params_from = anomaly_params_from_flax
    adam = next((s for s in opt_state
                 if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    step = float(np.asarray(adam.count))
    mu = params_from(adam.mu)
    nu = params_from(adam.nu)
    names = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    sd["state"] = {}
    for group, packed in zip(optimizer.param_groups, sd["param_groups"]):
        for param, idx in zip(group["params"], packed["params"]):
            name = names[id(param)]
            # a non-fused Adam(W) keeps its step count on the host
            sd["state"][idx] = {"step": torch.tensor(step),
                                "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    optimizer.load_state_dict(sd)


def transformer_params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX transformer's parameter tree (``init_params``; numpy leaves)
    -> the port's ``TelemetryTransformer`` ``state_dict``. A JAX dense
    ``w`` is [in, out]; ``nn.Linear.weight`` keeps [out, in]. LayerNorm
    ``g`` / ``b`` become ``weight`` / ``bias``."""
    out: dict[str, torch.Tensor] = {}

    def dense(prefix: str, p) -> None:
        out[f"{prefix}.weight"] = _f32(p["w"]).t().contiguous()
        out[f"{prefix}.bias"] = _f32(p["b"])

    def norm(prefix: str, p) -> None:
        out[f"{prefix}.weight"] = _f32(p["g"])
        out[f"{prefix}.bias"] = _f32(p["b"])

    dense("embed", params["embed"])
    dense("readout", params["readout"])
    norm("ln_f", params["ln_f"])
    for i, blk in enumerate(params["blocks"]):
        for name in ("ln1", "ln2"):
            norm(f"blocks.{i}.{name}", blk[name])
        for name in ("qkv", "proj", "mlp_in", "mlp_out"):
            dense(f"blocks.{i}.{name}", blk[name])
    return out


def _tensor(x, dev: torch.device) -> torch.Tensor:
    # torch.tensor copies, so the port never aliases the caller's arrays
    return torch.tensor(np.asarray(x)).to(dev)


def _dataclass_from(cls, tree, dev: torch.device, static: tuple = ()):
    """``cls`` with every tensor field read from the same-named attribute
    of ``tree``; the ``static`` fields (plain Python structure) are taken
    as they are, tuples of ints."""
    out = {}
    for f in dataclasses.fields(cls):
        x = getattr(tree, f.name)
        out[f.name] = (tuple(tuple(int(v) for v in row) for row in x)
                       if f.name in static else _tensor(x, dev))
    return cls(**out)


def _optional(cls, tree, dev: torch.device, static: tuple = ()):
    return None if tree is None else _dataclass_from(cls, tree, dev, static)


def pipeline_state_from_numpy(tree, device: str | torch.device = DEFAULT_DEVICE
                              ) -> PipelineState:
    """A JAX ``PipelineState`` pulled to the host (numpy leaves, read by
    attribute name) -> the port's ``PipelineState`` on ``device``, with
    its geofence zones and streaming-rules tier when they are installed
    (a rule block's static ``layout`` carries across as it is)."""
    dev = resolve_device(device)
    rules = getattr(tree, "rules", None)
    return PipelineState(
        registry=_dataclass_from(RegistryTables, tree.registry, dev),
        device_state=_dataclass_from(DeviceStateStore, tree.device_state, dev),
        store=_dataclass_from(EventStore, tree.store, dev),
        next_device=_tensor(tree.next_device, dev),
        next_assignment=_tensor(tree.next_assignment, dev),
        metrics=_dataclass_from(PipelineMetrics, tree.metrics, dev),
        windows=_optional(TelemetryWindows, getattr(tree, "windows", None), dev),
        zones=_optional(ZoneTable, getattr(tree, "zones", None), dev),
        rules=None if rules is None else RulesState(
            rules=_optional(RuleBlock, rules.rules, dev, static=("layout",)),
            rollups=_optional(RollupBlock, rules.rollups, dev)),
    )


class _ShardSlice:
    """Shard ``s`` of a stacked state tree read by attribute: array leaves
    indexed ``[s]``, subtrees sliced the same way, static fields (a rule
    block's ``layout``) and None as they are."""

    def __init__(self, tree, s: int):
        self._tree, self._s = tree, s

    def __getattr__(self, name):
        x = getattr(self._tree, name)
        if x is None or isinstance(x, (tuple, list, int, float, bool, str)):
            return x
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return np.asarray(x)[self._s]
        return _ShardSlice(x, self._s)


def shard_states_from_numpy(tree, devices: list) -> list[PipelineState]:
    """A JAX stacked ``PipelineState`` (numpy leaves ``[n_shards, ...]``,
    e.g. ``jax.device_get`` of a ``SpmdEngine``'s state) -> the port's
    per-shard states, shard ``s`` on ``devices[s]``."""
    return [pipeline_state_from_numpy(_ShardSlice(tree, s), d)
            for s, d in enumerate(devices)]


def shard_states_to_numpy(states: list[PipelineState]):
    """The port's per-shard states -> one stacked tree of numpy leaves
    ``[n_shards, ...]`` read by attribute, shaped like a JAX stacked
    state pulled to the host (static fields taken from shard 0)."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return np.stack([x.cpu().numpy() for x in states])
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return types.SimpleNamespace(**{
            f.name: shard_states_to_numpy([getattr(st, f.name) for st in states])
            for f in dataclasses.fields(first)})
    return first
