"""Whole-stage fusion planner pass (`spark_rapids_tpu/plan/fusion.py`).

Behind `spark.rapids.tpu.fusion.enabled`, the pass finds MAXIMAL chains of
batch-shape-compatible operators:

  * `TpuProjectExec` / `TpuFilterExec`,
  * the probe side of a `TpuBroadcastHashJoinExec` whose build child is a
    `TpuBroadcastExchangeExec` (inner/left/semi/anti/existence: the join
    types with no unmatched-build pass after the stream; with or without a
    condition, since every expression of this engine runs on the device;
    not zipped),
  * a stage-TERMINAL partial `TpuHashAggregateExec`, which the distribution
    pass (exec/requirements.py) creates under a mesh,

and replaces each chain of at least `fusion.minOps` members with one
`exec/fused.py TpuFusedStageExec`. Everything else breaks the chain:
complete and final aggregates merge across the whole batch stream,
exchanges move rows between positions, Expand and Sample end it as in the
JAX pass (a partial aggregate above either runs unfused), and a join
carrying dynamic-pruning filters fills them from its build before its
probe scan starts.
"""

from __future__ import annotations

KEY_ENABLED = "spark.rapids.tpu.fusion.enabled"
KEY_MIN_OPS = "spark.rapids.tpu.fusion.minOps"
KEY_PALLAS = "spark.rapids.tpu.fusion.pallas.mode"

FUSIBLE_JOIN_TYPES = ("inner", "left", "semi", "anti", "existence")

__all__ = ["apply_fusion", "FusedStageSpec", "KEY_ENABLED", "KEY_MIN_OPS",
           "KEY_PALLAS", "FUSIBLE_JOIN_TYPES"]


class FusedStageSpec:
    """Identity of one fused stage: the source schema plus one signature
    string per member (bound-expression reprs, key ordinals, join type,
    schemas, and a join's ANSI mode, which decides whether its condition
    raises)."""

    __slots__ = ("source", "members")

    def __init__(self, source: str, members):
        self.source = source
        self.members = tuple(members)

    def __repr__(self):
        return (f"FusedStageSpec(source={self.source}, "
                f"members=[{'; '.join(self.members)}])")


def _schema_sig(schema) -> str:
    return (f"{tuple(schema.names)!r}:"
            f"{[t.simple_string() for t in schema.types]!r}")


def _member_sig(m) -> str:
    from ..exec.aggregate import TpuHashAggregateExec
    from ..exec.basic import TpuFilterExec, TpuProjectExec
    from ..exec.joins import TpuBroadcastHashJoinExec
    if isinstance(m, TpuProjectExec):
        return f"Project[{m._bound!r} -> {_schema_sig(m._schema)}]"
    if isinstance(m, TpuFilterExec):
        return f"Filter[{m._bound!r} @ {_schema_sig(m.child.output)}]"
    if isinstance(m, TpuBroadcastHashJoinExec):
        cond = "None" if m._bcond is None else repr(m._bcond)
        return (f"BroadcastHashJoin[{m.join_type}, lk={m._lk_ix!r}, "
                f"rk={m._rk_ix!r}, cond={cond}, "
                f"build={_schema_sig(m.children[1].output)}, "
                f"out={_schema_sig(m.output)}, ansi={m.conf.is_ansi!r}]")
    if isinstance(m, TpuHashAggregateExec):
        aggs = [(repr(a.func), a.name) for a in m._bound_aggs]
        return (f"PartialAgg[keys={m._bound_groups!r}, aggs={aggs!r}, "
                f"out={_schema_sig(m.output)}]")
    raise TypeError(f"not a fusible member: {type(m).__name__}")


def apply_fusion(root, conf):
    if root is None or not conf.get(KEY_ENABLED):
        return root
    return _walk(root, conf)


def _walk(node, conf):
    """Fuse below `node`, walking into both bridges of a mixed plan (JAX
    `_walk`): a host node's device subtrees under CpuFromTpuExec, and a
    TpuFromCpuExec's host subtree. No chain crosses a bridge."""
    from ..exec.transitions import CpuFromTpuExec, TpuFromCpuExec
    if isinstance(node, CpuFromTpuExec):
        node.tpu_exec = _walk(node.tpu_exec, conf)
        return node
    if isinstance(node, TpuFromCpuExec):
        node.cpu_plan = _walk(node.cpu_plan, conf)
        return node
    fused = _try_fuse(node, conf)
    if fused is not None:
        # recurse BELOW the stage only (source + build exchanges)
        fused.children = [_walk(c, conf) for c in fused.children]
        return fused
    if node.children:
        node.children = [_walk(c, conf) for c in node.children]
    return node


def _fusible(node, head: bool) -> bool:
    from ..exec.aggregate import TpuHashAggregateExec
    from ..exec.basic import TpuFilterExec, TpuProjectExec
    from ..exec.broadcast import TpuBroadcastExchangeExec
    from ..exec.joins import TpuBroadcastHashJoinExec
    if isinstance(node, (TpuProjectExec, TpuFilterExec)):
        return True
    if isinstance(node, TpuBroadcastHashJoinExec):
        return (node.join_type in FUSIBLE_JOIN_TYPES
                and not node.zip_partitions and not node.dpp_filters
                and isinstance(node.children[1], TpuBroadcastExchangeExec))
    if isinstance(node, TpuHashAggregateExec):
        return head and node.mode == "partial"
    return False


def _try_fuse(node, conf):
    """Replace the maximal fusible chain headed at `node` (if >= minOps
    members) with a TpuFusedStageExec; None when nothing fuses."""
    from ..exec.base import TpuExec
    if not isinstance(node, TpuExec):  # a host plan node
        return None
    chain = []
    cur = node
    while _fusible(cur, head=cur is node):
        chain.append(cur)
        cur = cur.children[0]  # the probe/stream child for every member
    if len(chain) < max(2, int(conf.get(KEY_MIN_OPS))):
        return None
    members = list(reversed(chain))  # bottom-up (stream order)
    spec = FusedStageSpec(source=_schema_sig(cur.output),
                          members=tuple(_member_sig(m) for m in members))
    from ..exec.fused import TpuFusedStageExec
    return TpuFusedStageExec(members, spec, conf=conf)
