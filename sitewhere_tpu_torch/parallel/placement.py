"""The slot map of the multi-shard engines: which shard owns a device
token. A jax-free copy of ``sitewhere_tpu/parallel/cluster.py:105``
``owner_rank`` (FNV-1a over the token string) and of
``sitewhere_tpu/parallel/placement.py:111-145`` (``DEFAULT_SLOTS_PER_RANK``,
``slot_for_token``, ``shard_for_token``); nothing else of the cluster
modules, which are not ported.

Tokens hash into a fixed slot space of ``n_shards * slots_per_rank``
slots, and slot ``k`` belongs to shard ``k % n_shards``. Because
``n_shards`` divides the slot count, that is byte-identical to
``owner_rank(token, n_shards)``: a token lands on the same index whether
it names a cluster rank or a mesh shard.
"""

from __future__ import annotations

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1

DEFAULT_SLOTS_PER_RANK = 8


def owner_rank(token: str, n_ranks: int) -> int:
    """Owning rank of a device token: FNV-1a over the token string, stable
    across processes, restarts and interner orders."""
    h = _FNV_OFFSET
    for b in token.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h % n_ranks


def slot_for_token(token: str, n_shards: int,
                   slots_per_rank: int = DEFAULT_SLOTS_PER_RANK) -> int:
    """The slot a token hashes into (``n_slots = n_shards *
    slots_per_rank``): the unit the shard heat plane attributes rows to."""
    return owner_rank(token, n_shards * slots_per_rank)


def shard_for_token(token: str, n_shards: int,
                    slots_per_rank: int = DEFAULT_SLOTS_PER_RANK) -> int:
    """The shard that owns a token: its slot's genesis assignment,
    ``slot % n_shards``."""
    return slot_for_token(token, n_shards, slots_per_rank) % n_shards
