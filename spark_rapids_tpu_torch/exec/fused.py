"""Whole-stage fused execution (`spark_rapids_tpu/exec/fused.py`).

`plan/fusion.py` replaces a maximal chain of filter / project / broadcast
join probe / stage-terminal partial aggregate operators with one
`TpuFusedStageExec`. The JAX engine traces
the members into one XLA program per batch; this engine runs eagerly, so
the members' own per-batch functions run back to back on each batch and
their intermediates never leave the device. Results are identical to the
unfused chain by construction: the same functions run on the same inputs.

What fusion keeps from the JAX engine:

  * Join expand needs an output capacity. The stage computes each join's
    exact slot total on the device and reads all totals in ONE host sync
    per batch after the members up to the last join ran; a total above its
    capacity re-runs them at a grown, grow-only capacity. The members after
    the last join run once, after that sync.
  * The join sizing hash runs through the hand-written murmur3 kernel
    (ops/pallas_probe.py) when `spark.rapids.tpu.fusion.pallas.mode` is
    auto on a CUDA session, or force. The expand step still recomputes the
    plain hash, as the JAX engine does, so the kernel feeds only the sizing
    total and must match `_probe_counts` bit for bit.
  * A join member evaluates its condition inside the expand, as the
    unfused join does, and an existence member appends its `exists` flag.
  * A build side above `spark.rapids.sql.join.subPartition.rows` needs the
    sub-partition loop, so the whole stage then runs as its unfused member
    chain (the members keep their child links), as in the JAX engine.
  * Under the same switch the partial aggregate member's int64 segmented
    sums run through the hand-written kernel of ops/pallas_groupby.py: the
    `ops.rowops._FUSED_SEGMENT_SUM` seam is set while that member runs, and
    only then. Integer sums are exact, so the result is the same bits.
  * ANSI errors (per-member boxes, JAX `fused.py`): each member returns its
    errors with its batch, and the stage raises the first in member
    (stream) order, the unfused chain's message. The members up to the
    last join report in the sizing sync, read with the slot totals, and
    only from the run the stage keeps: a run discarded for a grown
    capacity drops its flags. The members after it report with the output
    row count; a stage without joins reads its flags once a batch.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from ..columnar.batch import ColumnarBatch, Schema
from ..columnar.padding import row_bucket
from ..errors import AnsiViolation
from .aggregate import TpuHashAggregateExec
from .base import TpuExec, batch_vecs, check_errors, read_flags, vecs_to_batch
from .basic import TpuProjectExec
from .joins import TpuBroadcastHashJoinExec, _expand_join, _probe_counts

__all__ = ["TpuFusedStageExec"]


class TpuFusedStageExec(TpuExec):
    """One fused pipeline stage. children = [source] + build exchanges (in
    member order); the member execs stay linked beneath."""

    def __init__(self, members: List[TpuExec], spec, conf=None):
        source = members[0].children[0]
        builds = [m.children[1] for m in members
                  if isinstance(m, TpuBroadcastHashJoinExec)]
        super().__init__([source] + builds, conf)
        self._members = list(members)
        self.spec = spec
        self._schema = members[-1].output
        self._join_members = [m for m in members
                              if isinstance(m, TpuBroadcastHashJoinExec)]
        # members up to the last join rerun when a join outgrows its
        # capacity; the rest (the partial aggregate included) run once per
        # batch, after the sizing sync
        last_join = max((i for i, m in enumerate(members)
                         if isinstance(m, TpuBroadcastHashJoinExec)),
                        default=-1)
        self._sized, self._tail = (self._members[:last_join + 1],
                                   self._members[last_join + 1:])
        # grow-only expand capacity per join member (None = size off the
        # first batch)
        self._join_caps: list = [None] * len(self._join_members)
        from ..plan.fusion import KEY_PALLAS
        mode = str(self.conf.get(KEY_PALLAS))
        self._pallas = mode == "force" or (
            mode == "auto" and self.device is not None
            and self.device.type == "cuda")

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        return f"[{self.spec!r}]"

    def _probe_total(self, m, probe: ColumnarBatch,
                     build: ColumnarBatch) -> torch.Tensor:
        """Exact expand-slot total for one join member, on the device (the
        unfused `join_pair` sizing formula)."""
        if self._pallas:
            from ..ops.pallas_probe import candidate_counts
            pvecs, bvecs = batch_vecs(probe), batch_vecs(build)
            counts = candidate_counts([pvecs[i] for i in m._lk_ix],
                                      [bvecs[i] for i in m._rk_ix],
                                      probe.row_mask(), build.row_mask())
        else:
            counts = _probe_counts(probe, build, m._lk_ix, m._rk_ix)[0]
        # no right/full member here; existence sizes by its candidates
        slot = torch.clamp(counts, min=1) if m.join_type == "left" else counts
        return torch.where(probe.row_mask(), slot, 0).sum(dtype=torch.int64)

    def _agg_member(self, m: TpuHashAggregateExec, batch: ColumnarBatch):
        """The terminal partial aggregate on one batch, with its ANSI
        errors; with the kernels engaged, the exact int64 segmented sum
        (ops/pallas_groupby) serves this member's group-by for its run
        only."""
        if not self._pallas:
            return m.aggregate(batch, output_partial=True)
        from ..ops import rowops
        from ..ops.pallas_groupby import fused_segment_sum
        prev = rowops._FUSED_SEGMENT_SUM
        rowops._FUSED_SEGMENT_SUM = fused_segment_sum
        try:
            return m.aggregate(batch, output_partial=True)
        finally:
            rowops._FUSED_SEGMENT_SUM = prev

    def _run_chain(self, members, batch: ColumnarBatch, builds=(), caps=()):
        """Run `members` on one batch: (the output, each join's slot total,
        the members' ANSI errors in member order)."""
        out, totals, errors, ji = batch, [], [], 0
        for m in members:
            if isinstance(m, TpuBroadcastHashJoinExec):
                totals.append(self._probe_total(m, out, builds[ji]))
                out_vecs, n, _, errs = _expand_join(
                    out, builds[ji], m._lk_ix, m._rk_ix, caps[ji],
                    m.join_type, m._bcond, m.conf.is_ansi)
                out = vecs_to_batch(m.output, out_vecs, n)
                ji += 1
            elif isinstance(m, TpuProjectExec):
                out, errs = m.project(out)
            elif isinstance(m, TpuHashAggregateExec):  # stage-terminal
                out, errs = self._agg_member(m, out)
            else:  # TpuFilterExec
                out, errs = m.filter(out)
            errors += errs
        return out, totals, errors

    def _caps_for(self, batch: ColumnarBatch) -> tuple:
        # members below a join keep the batch capacity, so the source cap is
        # the first-batch guess; overflow re-runs correct it, never shrink
        for i, cap in enumerate(self._join_caps):
            if cap is None:
                self._join_caps[i] = row_bucket(max(batch.capacity, 1))
        return tuple(self._join_caps)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        builds = []
        threshold = self.conf.get("spark.rapids.sql.join.subPartition.rows")
        for m in self._join_members:
            build = m.build_batch()
            if build is None:
                if m.join_type in ("inner", "semi"):
                    return
                build = m.empty_build()
            if build.row_count() > threshold:
                # the sub-partition join is a host loop: the members run
                # unfused (the broadcast builds are not made again)
                yield from self._members[-1].execute()
                return
            builds.append(build)
        for b in self.children[0].execute():
            while True:
                caps = self._caps_for(b)
                out, totals, errors = self._run_chain(self._sized, b, builds,
                                                      caps)
                if not totals:
                    break
                grown = False
                # the one per-batch host sync: every join's slot total, and
                # the sized members' ANSI flags
                sizes, first = read_flags(errors, totals)
                for i, t in enumerate(sizes):
                    if t > caps[i]:
                        self._join_caps[i] = row_bucket(max(t, 1))
                        grown = True
                if not grown:
                    if first is not None:
                        raise AnsiViolation(first)
                    break
            out, _, errors = self._run_chain(self._tail, out)
            if not self._join_members:
                check_errors(errors)
                yield out
                continue
            n, = check_errors(errors, [out.num_rows])
            if n == 0:
                continue  # unfused joins drop empty outputs too
            yield out
