"""Host-side sharding helpers."""
from __future__ import annotations


def owned_range(n_items: int, process_id: int = 0, process_count: int = 1):
    """Contiguous [lo, hi) shard of an item axis owned by this process.

    The host-sharded store policy: each process extracts / matches / pages
    only its image range (the reference's per-image files map naturally to
    per-host shards — SURVEY §5); resume stays per shard.
    """
    per = -(-n_items // process_count)
    lo = min(process_id * per, n_items)
    return lo, min(lo + per, n_items)
