"""Distribution requirements pass (`spark_rapids_tpu/exec/requirements.py`),
the EnsureRequirements analog that makes planned queries ride the mesh.

The frontend builds plans without exchanges. Under
`spark.rapids.shuffle.mode=ICI` with a mesh of at least two positions, this
pass rewrites the converted device plan:

  * a shuffled hash join (right and full ones too) gets a hash
    key-exchange under each child, sized to the mesh, and joins
    co-partitioned batches position by position; a nested-loop join is
    left as it is, as the JAX pass leaves it;
  * a complete grouped aggregate splits into partial -> key-exchange ->
    final, and the final side reduces each shard on its own (groups are
    disjoint across partitions).
"""

from __future__ import annotations

from ..config import TpuConf
from .base import TpuExec

__all__ = ["ensure_distribution"]


def ensure_distribution(root: TpuExec, conf: TpuConf) -> TpuExec:
    """Rewrite a device plan for the mesh. No-op unless the shuffle mode is
    ICI and a mesh is set."""
    if conf.get("spark.rapids.shuffle.mode") != "ICI":
        return root
    from ..parallel.mesh import mesh_from_conf
    mesh = mesh_from_conf(conf, root.device)
    if mesh is None:
        return root
    return _rewrite(root, conf, len(mesh))


def _rewrite(node: TpuExec, conf: TpuConf, ndev: int) -> TpuExec:
    from .aggregate import TpuHashAggregateExec
    from .joins import TpuBroadcastHashJoinExec, TpuShuffledHashJoinExec

    node.children = [_rewrite(c, conf, ndev) for c in node.children]

    if (isinstance(node, TpuShuffledHashJoinExec)
            and not isinstance(node, TpuBroadcastHashJoinExec)):
        node.children = [
            _key_exchange(node.left_keys, node.children[0], conf, ndev),
            _key_exchange(node.right_keys, node.children[1], conf, ndev),
        ]
        node.zip_partitions = True
        return node

    # every aggregate this engine carries (sum, count, min, max) has a
    # mergeable partial form; the JAX package keeps its single-pass ones
    # complete here
    if (isinstance(node, TpuHashAggregateExec) and node.mode == "complete"
            and node.group_exprs):
        child = node.children[0]
        partial = TpuHashAggregateExec(node.group_exprs, node.aggs, child,
                                       conf, mode="partial")
        nk = len(node.group_exprs)
        from ..expr.base import AttributeReference
        key_refs = [AttributeReference(n) for n in partial.output.names[:nk]]
        exchange = _key_exchange(key_refs, partial, conf, ndev)
        return TpuHashAggregateExec(node.group_exprs, node.aggs, exchange,
                                    conf, mode="final",
                                    agg_bind_schema=child.output,
                                    partitioned_input=True)
    return node


def _key_exchange(keys, child: TpuExec, conf: TpuConf, ndev: int) -> TpuExec:
    """Wrap `child` in a hash key-exchange over the mesh, unless it already
    is one on the same keys (reuse the existing co-partitioning)."""
    from ..expr.base import AttributeReference
    from ..plan.nodes import HashPartitionSpec
    from .exchange import TpuShuffleExchangeExec

    if (isinstance(child, TpuShuffleExchangeExec)
            and isinstance(child.spec, HashPartitionSpec)
            and child.spec.num_partitions == ndev
            and len(child.spec.keys) == len(keys)
            and all(isinstance(a, AttributeReference)
                    and isinstance(b, AttributeReference)
                    and a.col_name == b.col_name
                    for a, b in zip(child.spec.keys, keys))):
        return child
    return TpuShuffleExchangeExec(HashPartitionSpec(list(keys), ndev), child,
                                  conf)
