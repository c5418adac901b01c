"""Sequence parallelism: ring attention and Ulysses all-to-all over a
``torch.distributed`` group (port of ``sitewhere_tpu/parallel/ring_attention.py``).

The JAX package runs these inside ``shard_map`` over a mesh axis; here each
rank of a process group holds one sequence shard and the collectives are
``torch.distributed``'s (gloo on the CPU, NCCL on the card).

  * **Ring attention** (:func:`ring_attention`): the sequence is split over
    the group's n ranks. Each rank keeps its query shard and passes the
    key/value shards around the ring (rank r sends to r+1, receives from
    r-1), folding each arriving block into the flash-attention running
    softmax, in plain torch ops as the JAX package runs it in ``jnp``
    (its per-hop update, :91-108). Causal masking uses global positions,
    from ``dist.get_rank(group)``.
  * **Ulysses** (:func:`ulysses_attention`): two all-to-alls re-shard [B,
    S/n, H, D] to [B, S, H/n, D] and back, with dense local attention per
    head group in between. Needs H % n == 0.

Gradients follow JAX's transposes, so that a replicated loss
backpropagated on every rank gives every rank JAX's gradient:
  * a ring hop (``ppermute``) is :class:`_RingShift`, whose backward sends
    the gradient the other way;
  * a sum over the group whose result every rank holds (``psum``) is
    :func:`all_sum`, whose backward is the identity: each rank's local
    term gets the replicated gradient once, not n times as
    ``torch.distributed.nn.functional.all_reduce``'s summed backward
    would give it;
  * a tensor every rank holds whole and feeds to its shard's computation
    (a replicated ``in_spec``, here the parameters and the ``_sharded``
    wrappers' inputs) is :func:`replicated`, identity forward, summed
    all-reduce backward: each rank ends with the whole gradient;
  * the all-to-all is ``torch.distributed.nn.functional.all_to_all``, its
    own transpose.
With one rank the hops, the all-to-alls and the gather are the identity
and are not called; :func:`all_sum` calls its all-reduce whatever the
group's size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from sitewhere_tpu_torch.ops.attention import _NEG_INF, _scores, mha_reference


def _peer(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """The shard of rank r - step arrives at rank r (a ring hop of
    ``step``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out, _peer(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """``lax.ppermute`` by ``step`` around the ring, with its transpose (the
    hop of ``-step``) as the backward."""

    @staticmethod
    def forward(ctx, x, step: int, group):
        ctx.step, ctx.group = step, group
        return _shift(x, step, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.step, ctx.group), None, None


def ring_shift(x: torch.Tensor, step: int = 1, group=None) -> torch.Tensor:
    """Rank r receives rank (r - step)'s ``x``; differentiable."""
    return _RingShift.apply(x, step, group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the group, on every rank. The
    backward is the identity (the transpose of a sum whose result is
    replicated), so a loss that every rank backpropagates reaches each
    local term once."""
    return _AllSum.apply(x, group)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if dist.get_world_size(ctx.group) > 1:
            g = g.contiguous().clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, which every rank holds whole, as the input of this rank's
    share of the work: the backward sums the ranks' gradients, so each
    rank ends with the whole gradient (the transpose of a replicated
    ``in_spec``)."""
    return _Replicated.apply(x, group)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.size = group, dist.get_rank(group), x.shape[1]
        if n == 1:
            return x.clone()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.size
        return g[:, lo:lo + ctx.size], None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
                   causal: bool = False, sm_scale: float | None = None) -> torch.Tensor:
    """Ring attention over sequence shards: q, k, v are this rank's [B,
    S/n, H, D] shards (rank r holds rows r S/n ..); returns its [B, S/n, H,
    D] output shard in ``q.dtype``. Differentiable: the hops carry the
    gradient back to the rank that owns each key/value shard.

    JAX runs n hops and drops the last one's result; here the n - 1 hops
    that are read run (the same output and gradient, one transfer less)."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    b, sq, h, d = q.shape
    q_off = idx * sq
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        # after t hops this rank holds the block of rank (idx - t) mod n
        k_off = ((idx - t) % n) * sq
        s = _scores(q, k_cur, causal, sm_scale, q_off, k_off)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if t < n - 1:
            k_cur, v_cur = ring_shift(k_cur, 1, group), ring_shift(v_cur, 1, group)
    l = l.transpose(1, 2)[..., None]                 # [B, Sq, H, 1]
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe).to(q.dtype)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: chunk j of ``split_dim`` goes to rank j;
    the chunks received from ranks 0..n-1 are concatenated along
    ``concat_dim``. Differentiable."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    ins = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(ins[0]) for _ in range(n)]
    return torch.cat(dist_fn.all_to_all(outs, ins, group=group), dim=concat_dim)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
                      causal: bool = False, sm_scale: float | None = None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism on this rank's
    [B, S/n, H, D] shards; H % n == 0. [B, S/n, H, D] -> [B, S, H/n, D] ->
    local attention -> back. Differentiable."""
    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(f"ulysses_attention needs heads ({q.shape[2]}) divisible by "
                         f"the group size ({n})")
    qh, kh, vh = (_all_to_all(t, 2, 1, group) for t in (q, k, v))
    out = mha_reference(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return _all_to_all(out, 1, 2, group)


def _sharded(fn, q, k, v, group, **kw) -> torch.Tensor:
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} does not divide by the "
                         f"group size {n}")
    sl = q.shape[1] // n
    lo = dist.get_rank(group) * sl
    local = [replicated(t, group)[:, lo:lo + sl] for t in (q, k, v)]
    return _GatherSeq.apply(fn(*local, group, **kw), group)


def ring_attention_sharded(q, k, v, group=None, *, causal: bool = False,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Full [B, S, H, D] arrays on every rank -> the full result on every
    rank: each rank takes its sequence shard, runs :func:`ring_attention`,
    and the shards are gathered. S must divide by the group size. The
    gradient of the inputs is the whole gradient on every rank."""
    return _sharded(ring_attention, q, k, v, group, causal=causal, sm_scale=sm_scale)


def ulysses_attention_sharded(q, k, v, group=None, *, causal: bool = False,
                              sm_scale: float | None = None) -> torch.Tensor:
    """:func:`ring_attention_sharded` with :func:`ulysses_attention`."""
    return _sharded(ulysses_attention, q, k, v, group, causal=causal, sm_scale=sm_scale)
