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
key partitions by its murmur3 like any other. The
MULTITHREADED and CACHE_ONLY shuffle managers, the slicing path for an
exchange off the mesh, the sharded plan's aligned input, and range,
round-robin and single partitioning wait for later slices and raise at plan
time.
"""

from __future__ import annotations

from typing import Iterator, List

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column
from ..columnar.padding import row_bucket
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
        per_col = [len(c.leaves()) for c in g.columns]
        leaves = [t for c in g.columns for t in c.leaves()]
        shards = [[l[s * cap:(s + 1) * cap].to(mesh[s]) for l in leaves]
                  for s in range(ndev)]
        pids = [pid[s * cap:(s + 1) * cap].to(mesh[s]) for s in range(ndev)]

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
        for out_leaves, total in outs:
            it = iter(out_leaves)
            cols = tuple(Column(dt, *[next(it) for _ in range(k)])
                         for dt, k in zip(schema.types, per_col))
            yield ColumnarBatch(schema, cols, total)

    def _arg_string(self):
        return f"[{self.spec}]"
