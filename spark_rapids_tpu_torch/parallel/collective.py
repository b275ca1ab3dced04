"""The exchange between mesh positions (`spark_rapids_tpu/parallel/collective.py`
`bucketize_by_partition`, `compact_received` and `all_to_all_exchange`).

Each source position buckets its rows by destination into fixed-size
slots, the slots move to their destinations, and each destination compacts
what it received into one local shard and a count. The JAX package moves
the slots in one `lax.all_to_all` under `shard_map`; here a loop over
positions moves each slot block with `Tensor.to(destination)`, which is a
no-op where two positions share a card. Slots smaller than a position's
capacity can overflow on a skewed partition: the exchange reports that as
an on-device flag, and the caller reruns with doubled slots rather than
ever dropping rows. A leaf is any row-aligned buffer: 1-D, or 2-D like a
string column's byte matrix, whose rows move whole; empty slot rows are
zeros, so a string row keeps its zero tail.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["bucketize_by_partition", "compact_received",
           "all_to_all_exchange"]


def bucketize_by_partition(leaves: Sequence[torch.Tensor], pid: torch.Tensor,
                           ndev: int, slot_cap: int):
    """Group one position's rows by destination into [ndev, slot_cap, ...]
    slot buffers. pid is int32[cap] with -1 for padding and values in
    [-1, ndev).
    Returns (slotted leaves, send_counts int32[ndev], overflowed bool[])."""
    cap = pid.shape[0]
    key = torch.where(pid >= 0, pid, ndev).to(torch.int64)
    order = torch.sort(key, stable=True).indices
    key_sorted = key[order]
    counts = torch.bincount(key, minlength=ndev + 1)[:ndev].to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    # rank of each sorted row within its destination group
    rank = torch.arange(cap, dtype=torch.int32, device=pid.device) - \
        offsets[key_sorted.clamp(0, ndev - 1)]
    in_slot = (key_sorted < ndev) & (rank < slot_cap)
    # rows that do not fit go to one spare row past the slots, cut below
    slot_index = torch.where(in_slot, key_sorted * slot_cap + rank,
                             ndev * slot_cap)
    slotted = []
    for leaf in leaves:
        out = leaf.new_zeros((ndev * slot_cap + 1,) + leaf.shape[1:])
        out[slot_index] = leaf[order]
        slotted.append(out[:ndev * slot_cap].reshape(
            (ndev, slot_cap) + leaf.shape[1:]))
    return slotted, torch.clamp(counts, max=slot_cap), \
        (counts > slot_cap).any()


def compact_received(leaves: Sequence[torch.Tensor], recv_counts: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """[ndev, slot_cap, ...] received slots -> one compacted local shard.
    Row j of source block s is live iff j < recv_counts[s]. Returns (leaves
    of ndev * slot_cap rows, total int32)."""
    ndev, slot_cap = leaves[0].shape[0], leaves[0].shape[1]
    flat = [l.reshape((ndev * slot_cap,) + l.shape[2:]) for l in leaves]
    j = torch.arange(ndev * slot_cap, device=recv_counts.device)
    live = (j % slot_cap) < recv_counts[j // slot_cap]
    order = torch.sort((~live).to(torch.int8), stable=True).indices
    return [f[order] for f in flat], recv_counts.sum(dtype=torch.int32)


def all_to_all_exchange(shards: Sequence[Sequence[torch.Tensor]],
                        pids: Sequence[torch.Tensor],
                        positions: Sequence[torch.device], slot_cap: int):
    """The full exchange. shards[s] are source position s's leaves and
    pids[s] its partition ids, on positions[s]. Returns ([(leaves, total)
    per destination position, on that position], overflowed), where
    overflowed is a bool[] on positions[0] that is True iff any source
    overflowed a slot; the caller must check it and rerun larger."""
    ndev = len(positions)
    sent = [bucketize_by_partition(leaves, pid, ndev, slot_cap)
            for leaves, pid in zip(shards, pids)]
    overflowed = torch.stack([ov.to(positions[0])
                              for _, _, ov in sent]).any()
    out = []
    for d, dest in enumerate(positions):
        # destination d receives slot block d of every source, in source
        # order (lax.all_to_all's split_axis=0, concat_axis=0)
        recv = [torch.stack([slotted[li][d].to(dest)
                             for slotted, _, _ in sent])
                for li in range(len(shards[0]))]
        recv_counts = torch.stack([counts[d].to(dest)
                                   for _, counts, _ in sent])
        out.append(compact_received(recv, recv_counts))
    return out, overflowed
