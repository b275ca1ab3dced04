"""Partitioned exchange over the mesh (`spark_rapids_tpu/exec/exchange.py`
`make_partitioner` and `TpuShuffleExchangeExec` in ICI mode).

Only the distribution pass (exec/requirements.py) makes exchanges in this
engine, and only under `spark.rapids.shuffle.mode=ICI` with a mesh of at
least two positions, so the exec carries the mesh path `_exchange_via_mesh`
alone: the child's batches are concatenated, split into one shard per
position, and moved by `parallel/collective.py`. It yields exactly one
batch per position, empties included, so the zipped join and the per-shard
final aggregate downstream stay aligned position by position. A string
column crosses as two leaves, its byte matrix and its lengths, and a string
key partitions by its murmur3 like any other. A long-string column's head
and lengths cross with the rows; its tail bytes cross in a second
exchange whose unit is the byte (`_exchange_tail_bytes`): each source's
live rows' tail bytes in row order, each with its row's destination. Rows
and bytes both arrive in (source, row) order, so each destination's tail
offsets are the exclusive cumsum of its rows' tail lengths. The
MULTITHREADED and CACHE_ONLY shuffle managers, the slicing path for an
exchange off the mesh, the sharded plan's aligned input, and range,
round-robin and single partitioning wait for later slices and raise at plan
time.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column
from ..columnar.padding import row_bucket
from ..columnar.strings import blob_bucket, tail_byte_stream, \
    tail_starts_for
from ..parallel.collective import all_to_all_exchange
from ..parallel.mesh import mesh_from_conf
from ..parallel.partitioning import HashPartitioning, TpuPartitioning
from ..plan.nodes import HashPartitionSpec
from .base import UnaryTpuExec
from .coalesce import concat_batches

__all__ = ["TpuShuffleExchangeExec", "make_partitioner"]

# process-wide count of executed mesh exchanges (test/observability hook)
MESH_EXCHANGES = 0
# process-wide count of slot-overflow reruns (a bounded slot overflowed on a
# skewed partition and the exchange reran with doubled slots)
SLOT_OVERFLOW_RETRIES = 0


def _with_tails(col: Column, tail_out, hw: int, nrows) -> Column:
    """A destination's long-string column from its rows and its arrived
    tail bytes: live rows' tails lie back to back in row order."""
    data, nbytes = tail_out
    live = torch.arange(col.capacity, device=col.lengths.device) < nrows
    tail_lens = torch.where(live & col.validity, torch.clamp(
        col.lengths.to(torch.int64) - hw, min=0), 0)
    n = int(nbytes)
    blob = data.new_zeros(blob_bucket(n))
    blob[:n] = data[:n]
    return Column(col.dtype, col.data, col.validity, col.lengths,
                  (blob, tail_starts_for(tail_lens)))


def make_partitioner(spec, schema) -> TpuPartitioning:
    """Lower a plan-level partition spec to a device partitioner."""
    if isinstance(spec, HashPartitionSpec):
        return HashPartitioning.from_exprs(spec.keys, schema,
                                           spec.num_partitions)
    raise NotImplementedError(f"partitioning {spec!r} is not supported by "
                              "spark_rapids_tpu_torch yet (hash only)")


class TpuShuffleExchangeExec(UnaryTpuExec):
    """Repartition the child's stream over the mesh: one output batch per
    position, on that position's device."""

    def __init__(self, spec, child, conf=None):
        super().__init__([child], conf)
        self.spec = spec
        mode = self.conf.get("spark.rapids.shuffle.mode")
        if mode != "ICI":
            raise NotImplementedError(
                f"spark.rapids.shuffle.mode={mode} (the host shuffle "
                "manager) is not supported by spark_rapids_tpu_torch yet")
        self.mesh = mesh_from_conf(self.conf, child.device)
        if self.mesh is None or len(self.mesh) != spec.num_partitions:
            raise NotImplementedError(
                f"an exchange into {spec.num_partitions} partitions off a "
                "mesh of that size is not supported by "
                "spark_rapids_tpu_torch yet")
        self.partitioner = make_partitioner(spec, child.output)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute())
        if not batches:
            for dev in self.mesh:
                yield empty_batch(self.child.output, dev, 1)
            return
        yield from self._exchange_via_mesh(batches)

    def _exchange_via_mesh(self, batches: List[ColumnarBatch]
                           ) -> Iterator[ColumnarBatch]:
        """Concatenate, cut into one shard of `cap` rows per position, hash
        to partition ids, exchange with the overflow rerun, and yield one
        batch per position."""
        global MESH_EXCHANGES, SLOT_OVERFLOW_RETRIES
        mesh, ndev = self.mesh, len(self.mesh)
        batch = concat_batches(batches)
        schema = batch.schema
        cap = row_bucket(max(-(-batch.row_count() // ndev), 1))
        g = batch.repadded(ndev * cap)
        pid = self.partitioner.ids_for_batch(g)
        # the row plane: data, validity (, lengths) of every column
        per_col = [len(c.leaves()) - 2 * (c.overflow is not None)
                   for c in g.columns]
        leaves = [t for c, k in zip(g.columns, per_col)
                  for t in c.leaves()[:k]]
        shards = [[l[s * cap:(s + 1) * cap].to(mesh[s]) for l in leaves]
                  for s in range(ndev)]
        pids = [pid[s * cap:(s + 1) * cap].to(mesh[s]) for s in range(ndev)]
        tails = {ci: self._exchange_tail_bytes(c, pid, cap)
                 for ci, c in enumerate(g.columns) if c.overflow is not None}

        conf_slot = self.conf.get("spark.rapids.shuffle.ici.slotRows")
        slot_cap = min(conf_slot, cap) if conf_slot > 0 else cap
        while True:
            outs, overflowed = all_to_all_exchange(shards, pids, mesh,
                                                   slot_cap)
            if not bool(overflowed):
                break
            # slot_cap == cap can never overflow, so this terminates
            SLOT_OVERFLOW_RETRIES += 1
            slot_cap = min(slot_cap * 2, cap)
        MESH_EXCHANGES += 1
        for d, (out_leaves, total) in enumerate(outs):
            it = iter(out_leaves)
            cols = [Column(dt, *[next(it) for _ in range(k)])
                    for dt, k in zip(schema.types, per_col)]
            for ci, (tail_outs, hw) in tails.items():
                cols[ci] = _with_tails(cols[ci], tail_outs[d], hw, total)
            yield ColumnarBatch(schema, tuple(cols), total)

    def _exchange_tail_bytes(self, col: Column, pid: torch.Tensor,
                             cap: int):
        """The byte plane of one long-string column: every source's live
        rows' tail bytes, in row order, with their rows' destinations;
        the slot is a source's whole byte capacity, so it cannot
        overflow. Returns ([(bytes, count) per destination], head width)."""
        mesh, ndev = self.mesh, len(self.mesh)
        hw = col.data.shape[1]
        blob, ts = col.overflow
        tail_lens = torch.where((pid >= 0) & col.validity, torch.clamp(
            col.lengths.to(torch.int64) - hw, min=0), 0)
        streams = []
        for s in range(ndev):
            rows = slice(s * cap, (s + 1) * cap)
            data, row_of = tail_byte_stream(blob, ts[rows], tail_lens[rows])
            streams.append((data, pid[rows][row_of]))
        bcap = row_bucket(max(max(int(d.shape[0]) for d, _ in streams), 1))
        shards, pids = [], []
        for s, (data, bpid) in enumerate(streams):
            nb = int(data.shape[0])
            shards.append([torch.cat([data, data.new_zeros(bcap - nb)])
                           .to(mesh[s])])
            pids.append(torch.cat([bpid.to(torch.int32), torch.full(
                (bcap - nb,), -1, dtype=torch.int32, device=bpid.device)])
                .to(mesh[s]))
        outs, overflowed = all_to_all_exchange(shards, pids, mesh, bcap)
        if bool(overflowed):
            raise RuntimeError("the tail byte exchange overflowed a slot "
                               "that holds a source's every byte")
        return [(leaves[0], total) for leaves, total in outs], hw

    def _arg_string(self):
        return f"[{self.spec}]"
