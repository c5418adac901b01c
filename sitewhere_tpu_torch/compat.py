"""Device resolution and small tensor helpers shared by the port.

Every entry point of the port takes an explicit ``device``. The default is
``"cuda"``: a missing GPU raises instead of silently running on the CPU,
so a measurement can never be taken on the wrong device by accident.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but
    no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor,
                 src: torch.Tensor | float | int | bool) -> torch.Tensor:
    """New tensor = ``dst`` with rows ``idx`` set to ``src`` along dim 0;
    rows whose index lies outside ``[0, len(dst))`` are dropped — JAX's
    ``.at[idx].set(src, mode="drop")``. Torch raises (CPU) or writes
    arbitrary memory (CUDA) on an out-of-bounds index, so the rows are
    steered into one spare row that is cut off afterwards. In-bounds
    indices must be unique: a duplicate-index write has no defined winner
    on CUDA. No call site of the fused step relies on duplicates carrying
    equal values any more (the presence write is a scatter-min, see
    ``ops/window.py``)."""
    n = dst.shape[0]
    buf = dst.new_empty((n + 1,) + tuple(dst.shape[1:]))
    buf[:n] = dst
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    if not isinstance(src, torch.Tensor):
        src = torch.tensor(src, dtype=dst.dtype, device=dst.device)
    buf.index_put_((safe,), src.to(dst.dtype))
    return buf[:n]


def scatter_reduce_drop(dst: torch.Tensor, idx: torch.Tensor,
                        src: torch.Tensor, reduce: str) -> torch.Tensor:
    """``.at[idx].min/max/add(src, mode="drop")`` along dim 0 of ``dst``:
    ``reduce`` is ``"amin"``, ``"amax"`` or ``"sum"``; the existing values
    take part (``include_self=True``). ``idx`` is 1-D; ``src`` holds one
    row of ``dst.shape[1:]`` per index. A float ``"sum"`` adds duplicate
    indices in no fixed order on CUDA: it equals the CPU's only where
    every partial sum is exact."""
    n = dst.shape[0]
    rest = tuple(dst.shape[1:])
    buf = dst.new_empty((n + 1,) + rest)
    buf[:n] = dst
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    src = src.to(dst.dtype)
    if rest:
        safe = safe.view((-1,) + (1,) * len(rest)).expand(src.shape)
    buf.scatter_reduce_(0, safe, src, reduce=reduce, include_self=True)
    return buf[:n]


def flat_index(idx: tuple[torch.Tensor, ...], shape: tuple[int, ...]
               ) -> torch.Tensor:
    """Row-major linear index of the multi-dimensional index ``idx`` into
    ``shape``, and -1 where any component is out of bounds, so that the
    1-D drop/fill helpers drop or fill it as JAX's multi-dimensional
    ``mode="drop"`` / ``mode="fill"`` does."""
    lin = torch.zeros_like(idx[0])
    ok = torch.ones_like(idx[0], dtype=torch.bool)
    for i, n in zip(idx, shape):
        ok &= (i >= 0) & (i < n)
        lin = lin * n + i
    return torch.where(ok, lin, -1)


def gather_fill(src: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """``src.at[idx].get(mode="fill", fill_value=fill)`` on a 1-D ``src``
    (any shape of ``idx``)."""
    n = src.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, src[torch.where(ok, idx, 0).long()], fill)
