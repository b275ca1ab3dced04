"""Range, Sample and Expand of spark_rapids_tpu_torch against the JAX
engine on the CPU, from the same seeded inputs.

Each query runs on the port's device plan (`device="cpu"`) and its host
engine (`collect_cpu`), and on the JAX engine's `collect()` and
`collect_cpu()`: Range with a negative step, an empty range and many
batches; Sample's mask bit for bit against the JAX `sample_mask` (offsets
near 2^63 too) and the rows it keeps across batches; Expand as a
rollup with typed null literals, its ANSI errors inside a projection, and
under the distributed, fused plan (its partial aggregate sits above the
Expand, which ends fusion's chain, as in the JAX engine).

Tolerance: exact (f64 sums of the rollup rtol 1e-12)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.errors import AnsiViolation as JaxAnsiViolation
from spark_rapids_tpu.frontend import DataFrame as JaxDataFrame
from spark_rapids_tpu.ops.rowops import sample_mask as jax_sample_mask
from spark_rapids_tpu.plan.nodes import CpuExpandExec as JaxExpand
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import AnsiViolation
from spark_rapids_tpu_torch.frontend import DataFrame
from spark_rapids_tpu_torch.ops.rowops import sample_mask
from spark_rapids_tpu_torch.plan.nodes import CpuExpandExec
from spark_rapids_tpu_torch.plugin import TpuSession

SMALL_BATCH = {"spark.rapids.sql.explain": "NONE",
               "spark.rapids.sql.batchSizeRows": 128}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        "spark.rapids.tpu.fusion.enabled": True}


def _sessions(conf):
    return TpuSession(conf, device="cpu"), JaxSession(conf)


def _all_equal(port_df, jax_df, sort_by=None, approx=(), jax_device=True):
    """The port's two engines and the JAX engine's two (its CPU engine
    alone without `jax_device`: its mesh programs compile for seconds),
    one table."""
    tables = [port_df.collect(), port_df.collect_cpu(),
              jax_df.collect_cpu()]
    if jax_device:
        tables.insert(2, jax_df.collect())
    if sort_by:
        tables = [t.sort_by([(k, "ascending") for k in sort_by])
                  for t in tables]
    want = tables[-1].to_pydict()
    for t in tables:
        got = t.to_pydict()
        assert list(got) == list(want)
        for k in want:
            if k in approx:
                assert np.allclose(np.array(got[k], float),
                                   np.array(want[k], float), rtol=1e-12)
            else:
                assert got[k] == want[k], k
    return tables[0]


@pytest.mark.parametrize("start,end,step", [
    (0, 10, 1), (10, -7, -3), (5, 5, 1), (3, 1, 1), (0, 1000, 7),
    (-50, 600, 1), (1000, -1000, -9), (2 ** 40, 2 ** 40 + 300, 2)])
def test_range_equals_jax(start, end, step):
    """Batches of 128 rows (many batches for the long ranges), ceil
    division for either sign of step, one empty batch for an empty
    range."""
    ps, js = _sessions(SMALL_BATCH)
    out = _all_equal(ps.range(start, end, step), js.range(start, end, step))
    assert out.column("id").to_pylist() == list(range(start, end, step))


def test_range_batches():
    from spark_rapids_tpu_torch.exec.basic import TpuRangeExec
    ex = TpuRangeExec(0, 300, 1, torch.device("cpu"), batch_rows=128)
    assert [b.row_count() for b in ex.execute()] == [128, 128, 44]
    ex = TpuRangeExec(7, 7, 1, torch.device("cpu"), batch_rows=128)
    assert [b.row_count() for b in ex.execute()] == [0]
    ex = TpuRangeExec(10, 0, -1, torch.device("cpu"), batch_rows=4)
    assert [b.row_count() for b in ex.execute()] == [4, 4, 2]


@pytest.mark.parametrize("offset", [0, 1, 999_999, 2 ** 62, 2 ** 63 - 77,
                                    2 ** 63, 2 ** 64 - 300])
@pytest.mark.parametrize("seed", [0, 17, 42, -1, 2 ** 64 + 5])
def test_sample_mask_bit_for_bit(offset, seed):
    """The int64 splitmix64 keeps the JAX uint64 mask's rows, past the
    wrap of the ordinal at 2^63 and 2^64 too."""
    for fraction in (0.0, 0.01, 0.5, 1.0):
        want = jax_sample_mask(np, 1000, offset, fraction, seed)
        off = torch.tensor(offset - (1 << 64) if offset >= 1 << 63
                           else offset)
        got = sample_mask(1000, off, fraction, seed, "cpu").numpy()
        assert np.array_equal(got, want)


def _sales(n=1000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 7, n)),
        "s": pa.array([None if i % 9 == 0 else f"s{i % 5}"
                       for i in range(n)]),
        "v": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "d": pa.array(rng.normal(0, 1, n))})


@pytest.mark.parametrize("fraction,seed", [(0.3, 17), (0.01, 5), (0.0, 1),
                                           (1.0, 2)])
def test_sample_rows_across_batches(fraction, seed):
    """The global row ordinal runs across the 128-row batches: the port's
    two engines keep the JAX engine's rows, the rows of the mask."""
    t = _sales()
    ps, js = _sessions(SMALL_BATCH)
    out = _all_equal(ps.from_arrow(t).sample(fraction, seed),
                     js.from_arrow(t).sample(fraction, seed))
    keep = jax_sample_mask(np, t.num_rows, 0, fraction, seed)
    assert out.column("v").to_pylist() == \
        np.asarray(t.column("v"))[keep].tolist()


def test_sample_after_filter_and_aggregate():
    """A filter before the sample: the ordinal counts the rows that reach
    it. The grouped result equals the JAX engine's on both plans."""
    t = _sales(3000, 9)
    for conf in (SMALL_BATCH, dict(SMALL_BATCH, **MESH)):
        ps, js = _sessions(conf)

        def q(s, E):
            return s.from_arrow(t).filter(E.col("v") > E.lit(0)) \
                .sample(0.4, 23).group_by("k") \
                .agg(n=E.Count(E.lit(1)), sv=E.Sum(E.col("v")))
        _all_equal(q(ps, PE), q(js, JE), sort_by=["k"],
                   jax_device=conf is SMALL_BATCH)


def _rollup(sess, E, types, df, mod):
    """rollup(k, s) over df: Expand with the grouping id g, then sums by
    (k, s, g) and grouping(s) as g & 1."""
    cols = ("k", "s", "v", "d")
    levels = ((0, ()), (1, ("s",)), (3, ("k", "s")))
    null = {"k": types.LONG, "s": types.STRING}
    projections = [[E.lit(None, null[c]) if c in nulled else E.col(c)
                    for c in cols] + [E.lit(g)] for g, nulled in levels]
    node = mod.CpuExpandExec(projections, cols + ("g",), df.plan)
    return mod.DataFrame(sess, node).group_by("k", "s", "g").agg(
        n=E.Count(E.lit(1)), sv=E.Sum(E.col("v")), sd=E.Sum(E.col("d")),
        mx=E.Max(E.col("v")))


class _Port:
    CpuExpandExec, DataFrame = CpuExpandExec, DataFrame


class _Jax:
    CpuExpandExec, DataFrame = JaxExpand, JaxDataFrame


@pytest.mark.parametrize("conf", [SMALL_BATCH, dict(SMALL_BATCH, **MESH)],
                         ids=["one_device", "distributed_fused"])
def test_rollup_equals_jax(conf):
    """A rollup's three levels (null keys in the data and as typed null
    literals), each Expand projection one batch per input batch."""
    t = _sales(700, 11)
    ps, js = _sessions(conf)
    p = _rollup(ps, PE, T, ps.from_arrow(t), _Port)
    j = _rollup(js, JE, JT, js.from_arrow(t), _Jax)
    out = _all_equal(p, j, sort_by=["g", "k", "s"], approx=("sd",),
                     jax_device=conf is SMALL_BATCH)
    g = out.column("g").to_pylist()
    assert g.count(3) == 1 and g.count(1) == 7
    assert sum(out.column("n").to_pylist()) == 3 * t.num_rows


def test_rollup_distributed_plan_matches_jax():
    """Under the mesh with fusion on: partial aggregate above the Expand,
    unfused (Expand ends fusion's chain), key exchange, final aggregate;
    the JAX engine's exec tree."""
    t = _sales(300, 4)
    ps, js = _sessions(dict(SMALL_BATCH, **MESH))
    p = _rollup(ps, PE, T, ps.from_arrow(t), _Port)
    j = _rollup(js, JE, JT, js.from_arrow(t), _Jax)

    def names(tree):
        return [ln.strip().split("[")[0].split("(")[0]
                for ln in tree.splitlines() if ln.strip()]
    jax_tree = JaxOverrides(js.conf).apply(j.plan).tree_string()
    assert names(p.explain()) == names(jax_tree)
    assert "TpuFusedStageExec" not in p.explain()
    assert names(p.explain())[:4] == [
        "TpuHashAggregateExec", "TpuShuffleExchangeExec",
        "TpuHashAggregateExec", "TpuExpandExec"]


def test_expand_batches_and_types():
    from spark_rapids_tpu_torch.exec.basic import TpuExpandExec, TpuScanExec
    t = _sales(300, 2)
    scan = TpuScanExec(t, torch.device("cpu"), batch_rows=128)
    ex = TpuExpandExec([[PE.col("v")], [PE.lit(5, T.INT)]], ["x"], scan)
    rows = [b.row_count() for b in ex.execute()]
    assert rows == [128, 128, 128, 128, 44, 44]
    with pytest.raises(NotImplementedError, match="Expand column"):
        ps = TpuSession(SMALL_BATCH, device="cpu")
        DataFrame(ps, CpuExpandExec([[PE.col("v")], [PE.lit("x")]], ["x"],
                                    ps.from_arrow(t).plan)).collect()


def test_expand_ansi_error_inside_a_projection():
    """The JAX test's Expand (test_ansi.py): a / d with d = 0 in one
    projection raises on every engine under ANSI; without ANSI it is
    null."""
    t = pa.table({"a": pa.array([10], pa.int64()),
                  "d": pa.array([0], pa.int64())})
    conf = {"spark.rapids.sql.explain": "NONE",
            "spark.sql.ansi.enabled": True}
    ps, js = _sessions(conf)
    p = DataFrame(ps, CpuExpandExec(
        [[PE.col("a"), PE.Divide(PE.col("a"), PE.col("d"))],
         [PE.col("a"), PE.lit(0.0)]], ["a", "r"], ps.from_arrow(t).plan))
    j = JaxDataFrame(js, JaxExpand(
        [[JE.col("a"), JE.Divide(JE.col("a"), JE.col("d"))],
         [JE.col("a"), JE.lit(0.0)]], ["a", "r"], js.from_arrow(t).plan))
    for run in (p.collect, p.collect_cpu):
        with pytest.raises(AnsiViolation, match="DIVIDE_BY_ZERO|zero"):
            run()
    for run in (j.collect, j.collect_cpu):
        with pytest.raises(JaxAnsiViolation):
            run()
    ps, js = _sessions({"spark.rapids.sql.explain": "NONE"})
    p = DataFrame(ps, CpuExpandExec(
        [[PE.col("a"), PE.Divide(PE.col("a"), PE.col("d"))],
         [PE.col("a"), PE.lit(0.0)]], ["a", "r"], ps.from_arrow(t).plan))
    assert p.collect().column("r").to_pylist() == [None, 0.0] == \
        p.collect_cpu().column("r").to_pylist()
