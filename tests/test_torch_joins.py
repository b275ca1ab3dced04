"""The joins of spark_rapids_tpu_torch (exec/joins.py, their planning in
plan/overrides.py, fusion and the distribution pass) against the JAX
engine on the CPU, from the same numpy seeds.

Every join type the JAX planner admits (inner, left, right, full, semi,
anti, existence, and cross) runs on int, long, date, timestamp, boolean,
double and float keys with NaN, -0.0 and nulls on both sides, string keys
held in different width buckets on the two sides (with a trailing NUL),
decimal(7,2) keys and a two-column key, on four plans: broadcast,
shuffled, distributed (key exchanges over 4 mesh positions, the join
zipped shard by shard) and fused. Then join conditions (one that reads
null), keyless nested-loop joins in bounded tiles, empty sides, the
sub-partition join forced by a small spark.rapids.sql.join.subPartition.rows
(in both engines' device paths), IN with nulls, and the explain trees.

Most cases hold the port against the JAX package's CPU engine
(`collect_cpu()`, its numpy oracle), which compiles nothing; the
sub-partition join and a few plans also run the JAX device engine.

Tolerance: exact, every column, rows compared as sorted lists (a NaN
equals a NaN; -0.0 and 0.0 are told apart by their sign)."""

import decimal
import math
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.exec import joins
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
SHUFFLED = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1}
PLANS = {
    "broadcast": BASE,
    "shuffled": dict(BASE, **SHUFFLED),
    "distributed": dict(BASE, **SHUFFLED, **{
        "spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4"}),
    # the sizing hash through kernel A's wrapper (its plain twin here): a
    # multi-column key's integral columns through A, the others through
    # hash_vec, bit for bit as the unfused probe
    "fused": dict(BASE, **{"spark.rapids.tpu.fusion.enabled": True,
                           "spark.rapids.tpu.fusion.pallas.mode": "force"}),
}
HOWS = ("inner", "left", "right", "full", "semi", "anti", "existence")
_NAMES = "col lit In IsNotNull Sum Count CaseWhen".split()
JNS = SimpleNamespace(**{n: getattr(JE, n) for n in _NAMES})
PNS = SimpleNamespace(**{n: getattr(PE, n) for n in _NAMES})

N_LEFT, N_RIGHT = 240, 90
# key pools: position 0 is the null slot; codes index the rest
_DOUBLES = [float("nan"), -0.0, 0.0, 1.5, -2.25, 1e300, -1e-300, 7.0,
            3.0e10, -0.5, 2.0 ** 60, 11.0]
_FLOATS = [float("nan"), -0.0, 0.0, 1.5, -2.25, 1e30, -1e-30, 7.0,
           3.0e10, -0.5, 2.0 ** 60, 11.0]
_STRINGS = ["", "a", "a\x00", "abc", "abcdefgh", "abcdefghi", "héllo",
            "zz", "x" * 17, "b", "é" * 5, "q q"]


def _key_array(kind: str, codes: np.ndarray, nulls: np.ndarray, side: str):
    """One key column of `kind` from integer codes. For `string_widths`
    the right side's strings include a 40-byte value, so equal strings sit
    in different width buckets on the two sides."""
    if kind == "int":
        return pa.array(codes.astype(np.int32), mask=nulls)
    if kind == "long":
        return pa.array(codes.astype(np.int64) * 10 ** 12 - 7, mask=nulls)
    if kind == "date":
        return pa.array((codes + 18_000).astype(np.int32), mask=nulls) \
            .cast(pa.date32())
    if kind == "timestamp":
        return pa.array(codes.astype(np.int64) * 3_600_000_000 + 17,
                        pa.timestamp("us", tz="UTC"), mask=nulls)
    if kind == "boolean":
        return pa.array(codes % 2 == 0, mask=nulls)
    if kind == "double":
        return pa.array(np.array(_DOUBLES)[codes % len(_DOUBLES)],
                        mask=nulls)
    if kind == "float":
        return pa.array(np.array(_FLOATS, np.float32)[codes % len(_FLOATS)],
                        mask=nulls)
    if kind in ("string", "string_widths"):
        wide = kind == "string_widths" and side == "right"
        pool = _STRINGS + (["w" * 40] if wide else [])
        return pa.array([None if n else pool[c % len(pool)]
                         for c, n in zip(codes, nulls)], pa.string())
    if kind == "decimal":
        return pa.array([None if n else decimal.Decimal(int(c) * 137 - 500)
                         .scaleb(-2) for c, n in zip(codes, nulls)],
                        pa.decimal128(7, 2))
    raise ValueError(kind)


def tables(kind: str, seed: int = 0, n_left: int = N_LEFT,
           n_right: int = N_RIGHT):
    """(left, right) Arrow tables: key `k` (and `k2` for the two-column
    key) with duplicates and 10 % nulls on both sides; left payloads `id`
    (never null), `a` (int32, some null) and `x` (double); right payloads
    `b` (int32, some null) and `s` (string)."""
    rng = np.random.default_rng(seed)

    def side(n, name):
        codes = rng.integers(0, 14, n)
        out = {}
        if kind == "long_string":
            out["k"] = _key_array("long", codes % 5, rng.random(n) < 0.1,
                                  name)
            out["k2"] = _key_array("string", codes // 3, rng.random(n) < 0.1,
                                   name)
        else:
            out["k"] = _key_array(kind, codes, rng.random(n) < 0.1, name)
        return out

    lk, rk = side(n_left, "left"), side(n_right, "right")
    left = pa.table(dict(lk, **{
        "id": pa.array(np.arange(n_left, dtype=np.int64)),
        "a": pa.array(rng.integers(-20, 20, n_left).astype(np.int32),
                      mask=rng.random(n_left) < 0.1),
        "x": pa.array(rng.normal(0, 10, n_left).round(3))}))
    right = pa.table(dict(rk, **{
        "b": pa.array(rng.integers(-20, 20, n_right).astype(np.int32),
                      mask=rng.random(n_right) < 0.1),
        "s": pa.array([f"r{i % 7}" for i in range(n_right)])}))
    return left, right


def _canon(v):
    if v is None:
        return (0,)
    if isinstance(v, float):
        return (1, "nan") if math.isnan(v) else (2, v, math.copysign(1, v))
    return (2, v)


def rows(t: pa.Table):
    """The table's rows as sorted tuples of comparable values, timestamps
    as their int64 microseconds."""
    cols = [pc.cast(c, pa.int64()) if pa.types.is_timestamp(c.type) else c
            for c in t.columns]
    return sorted(tuple(_canon(v) for v in r)
                  for r in zip(*[c.to_pylist() for c in cols]))


def canonical(t: pa.Table) -> pa.Table:
    """The table with positional names, floats as the int64 bits of their
    double value (one NaN; -0.0 and 0.0 apart), timestamps as int64, rows
    sorted by every column."""
    cols = []
    for c in t.columns:
        c = c.combine_chunks()
        if pa.types.is_floating(c.type):
            v = c.fill_null(0).to_numpy().astype(np.float64)
            c = pa.array(np.where(np.isnan(v), np.nan, v).view(np.int64),
                         mask=c.is_null().to_numpy(zero_copy_only=False))
        elif pa.types.is_timestamp(c.type):
            c = pc.cast(c, pa.int64())
        cols.append(c)
    t = pa.table(cols, names=[f"c{i}" for i in range(len(cols))])
    return t.sort_by([(n, "ascending") for n in t.column_names])


def assert_same(got: pa.Table, want: pa.Table):
    assert got.column_names == want.column_names
    for g, w in zip(got.schema, want.schema):
        if not pa.types.is_timestamp(w.type):
            assert g.type == w.type, (g, w)
    assert got.num_rows == want.num_rows, (got.num_rows, want.num_rows)
    assert canonical(got).equals(canonical(want))


def _keys(kind):
    return ["k", "k2"] if kind == "long_string" else ["k"]


def join_query(sess, m, left, right, how, kind, plan, condition=False):
    """left JOIN right on the keys; the fused plan filters the probe side
    first, so the filter and the broadcast probe form one stage."""
    lt = sess.from_arrow(left)
    if plan == "fused":
        lt = lt.filter(m.col("id") >= m.lit(0))
    cond = m.col("a") > m.col("b") if condition else None
    return lt.join(sess.from_arrow(right), on=_keys(kind), how=how,
                   condition=cond)


def both(plan, build, conf_extra=None):
    """The JAX query and the port's, over one conf."""
    conf = dict(PLANS[plan], **(conf_extra or {}))
    return (build(JaxSession(conf), JNS),
            build(TpuSession(conf, device="cpu"), PNS))


KINDS = ("int", "long", "date", "timestamp", "boolean", "double", "float",
         "string", "decimal", "long_string")


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("how", HOWS)
def test_equi_join(how, kind, plan):
    """Each join type on each key type and plan, exact against the JAX
    engine's CPU engine."""
    left, right = tables(kind, seed=len(kind))
    jq, pq = both(plan, lambda s, m: join_query(s, m, left, right, how,
                                                kind, plan))
    assert_same(pq.collect(), jq.collect_cpu())


def _shape(plan: str):
    return [(len(ln) - len(ln.lstrip()), ln.split("[")[0].strip())
            for ln in plan.splitlines() if ln.strip()]


def spark_join(left: pa.Table, right: pa.Table, how: str, keys):
    """Spark's equi-join rule in plain Python: a null key matches nothing,
    NaN matches NaN, -0.0 matches 0.0, strings match by their bytes. The
    output rows as `rows` gives them."""
    def key(r):
        ks = [r[k] for k in keys]
        if any(v is None for v in ks):
            return None
        return tuple("nan" if isinstance(v, float) and math.isnan(v) else
                     (v + 0.0 if isinstance(v, float) else v) for v in ks)
    lrows = [tuple(r.values()) for r in left.to_pylist()]
    rrows = [tuple(r.values()) for r in right.to_pylist()]
    lkeys = [key(r) for r in left.to_pylist()]
    rkeys = [key(r) for r in right.to_pylist()]
    lnull, rnull = (None,) * left.num_columns, (None,) * right.num_columns
    out, rhit = [], [False] * len(rrows)
    for lr, lk in zip(lrows, lkeys):
        hits = [j for j, rk in enumerate(rkeys)
                if lk is not None and rk == lk]
        for j in hits:
            rhit[j] = True
        if how == "existence":
            out.append(lr + (bool(hits),))
        elif how in ("semi", "anti"):
            if bool(hits) == (how == "semi"):
                out.append(lr)
        else:
            out.extend(lr + rrows[j] for j in hits)
            if not hits and how in ("left", "full"):
                out.append(lr + rnull)
    if how in ("right", "full"):
        out.extend(lnull + rr for rr, h in zip(rrows, rhit) if not h)
    return sorted(tuple(_canon(v) for v in r) for r in out)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("how", HOWS)
def test_string_keys_in_different_width_buckets(how, plan):
    """Equal strings held in different width buckets on the two sides (the
    build side also holds a 40-byte string) match, and a trailing NUL
    tells "a\\x00" from "a": exact against a Python oracle of Spark's
    rule. The JAX CPU engine packs a key's bytes at its side's width and
    matches no such pair (ROADMAP.md Queue C); its device engine agrees
    with the port."""
    left, right = tables("string_widths", seed=29)
    pq = join_query(TpuSession(PLANS[plan], device="cpu"), PNS, left, right,
                    how, "string_widths", plan)
    assert rows(pq.collect()) == spark_join(left, right, how, ["k"])


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("how", HOWS)
def test_join_condition_and_plan_shape(how, plan):
    """An equi join with a condition over both sides that reads null on
    some rows (a null `a` or `b` is no match), exact against the JAX CPU
    engine; its explain tree has the JAX engine's shape, a fused stage on
    the fused plan wherever the type fuses."""
    left, right = tables("long", seed=3)
    jq, pq = both(plan, lambda s, m: join_query(s, m, left, right, how,
                                                "long", plan, True))
    assert_same(pq.collect(), jq.collect_cpu())
    jplan = JaxOverrides(jq.session.conf).apply(jq.plan).tree_string()
    assert _shape(pq.explain()) == _shape(jplan)
    fused = plan == "fused" and how not in ("right", "full")
    assert ("TpuFusedStageExec" in pq.explain()) == fused
    if plan == "distributed" and how in ("right", "full"):
        assert "TpuShuffleExchangeExec" in pq.explain()


def test_condition_null_is_no_match():
    """tests/test_joins_extended.py's case: a left join whose condition is
    null on both rows keeps both probe rows unmatched."""
    lt = pa.table({"k": pa.array([1, 2], pa.int64()),
                   "a": pa.array([None, 5], pa.int32())})
    rt = pa.table({"k": pa.array([1, 2], pa.int64()),
                   "b": pa.array([0, None], pa.int32())})
    for plan in ("broadcast", "shuffled", "fused"):
        jq, pq = both(plan, lambda s, m: s.from_arrow(lt).join(
            s.from_arrow(rt), on="k", how="left",
            condition=m.col("a") > m.col("b")))
        got = pq.collect()
        assert_same(got, jq.collect_cpu())
        assert got.column(2).null_count == 2


@pytest.mark.parametrize("plan", ["broadcast", "shuffled"])
@pytest.mark.parametrize("how", HOWS + ("cross",))
def test_nested_loop_join(how, plan, monkeypatch):
    """Keyless joins: the cross join (as inner, no condition) and
    pure-condition joins of every type, through tiles of 8 probe rows x 8
    build rows (every probe batch and build side spans several), exact
    against the JAX CPU engine."""
    monkeypatch.setattr(joins.TpuNestedLoopJoinExec, "TILE_BUDGET", 64)
    monkeypatch.setattr(joins.TpuNestedLoopJoinExec, "PROBE_TILE_ROWS", 8)
    left, right = tables("int", seed=5, n_left=70, n_right=45)

    def q(s, m):
        cond = None if how == "cross" else \
            (m.col("a") == m.col("b")) | (m.col("x") > m.lit(18.0))
        return s.from_arrow(left).join(s.from_arrow(right), how=how,
                                       condition=cond)
    joins.COUNTERS.reset()
    jq, pq = both(plan, q)
    got = pq.collect()
    assert_same(got, jq.collect_cpu())
    assert "TpuNestedLoopJoinExec" in pq.explain()
    # 70 probe rows in 9 tiles, 45 build rows in 6 chunks
    assert joins.COUNTERS.snapshot()["nested_loop_tiles"] == 9 * 6
    if how == "cross":
        assert got.num_rows == 70 * 45


def test_cross_join_of_one_row_aggregates():
    """q28's form: one-row aggregates cross-joined into one row."""
    left, _ = tables("long", seed=9)

    def q(s, m):
        aggs = [s.from_arrow(left).filter(m.col("a") > m.lit(lo))
                .agg(**{f"n{i}": m.Count(m.lit(1)),
                        f"s{i}": m.Sum(m.col("id"))})
                for i, lo in enumerate((-30, 0, 10))]
        return aggs[0].cross_join(aggs[1]).cross_join(aggs[2])
    jq, pq = both("broadcast", q)
    got = pq.collect()
    assert got.num_rows == 1
    assert_same(got, jq.collect_cpu())


@pytest.mark.parametrize("side", ["left", "right", "both"])
@pytest.mark.parametrize("how", HOWS + ("cross",))
def test_empty_sides(how, side):
    """An empty probe side, build side or both (filtered to no rows):
    equi joins shuffled and nested-loop joins broadcast, exact against the
    JAX CPU engine."""
    left, right = tables("long", seed=7)

    def q(s, m):
        lt, rt = s.from_arrow(left), s.from_arrow(right)
        if side in ("left", "both"):
            lt = lt.filter(m.col("id") < m.lit(0))
        if side in ("right", "both"):
            rt = rt.filter(m.col("s") == m.lit("none"))
        if how == "cross":
            return lt.cross_join(rt)
        return lt.join(rt, on="k", how=how)
    for plan in ("shuffled", "broadcast"):
        jq, pq = both(plan, q)
        assert_same(pq.collect(), jq.collect_cpu())


@pytest.mark.parametrize("plan", ["shuffled", "distributed"])
@pytest.mark.parametrize("how", HOWS)
def test_sub_partition_join(how, plan):
    """A build side (one device) or build shard (distributed) of more than
    spark.rapids.sql.join.subPartition.rows = 16 rows splits into
    key-aligned sub-partitions joined pairwise; exact against the JAX CPU
    engine, and the counters show the split ran."""
    left, right = tables("string", seed=11, n_right=300)
    conf = {"spark.rapids.sql.join.subPartition.rows": 16}
    jq, pq = both(plan, lambda s, m: s.from_arrow(left).join(
        s.from_arrow(right), on="k", how=how,
        condition=m.col("a") > m.col("b")), conf)
    joins.COUNTERS.reset()
    assert_same(pq.collect(), jq.collect_cpu())
    snap = joins.COUNTERS.snapshot()
    assert snap["sub_partition_builds"] >= 1
    assert snap["sub_partition_pairs"] > snap["sub_partition_builds"]


def test_sub_partition_join_against_jax_device_engine():
    """A full join as q97 runs it, with the sub-partition path forced in
    both engines' device paths, over a long and a string key."""
    left, right = tables("long_string", seed=13, n_left=100, n_right=120)
    conf = {"spark.rapids.sql.join.subPartition.rows": 32}
    jq, pq = both("shuffled", lambda s, m: s.from_arrow(left).join(
        s.from_arrow(right), on=["k", "k2"], how="full"), conf)
    joins.COUNTERS.reset()
    assert_same(pq.collect(), jq.collect())
    assert joins.COUNTERS.snapshot()["sub_partition_builds"] >= 1


def test_fused_build_over_the_threshold_runs_unfused():
    """A broadcast build above the sub-partition threshold makes the fused
    stage run its members unfused, as the JAX engine's stage does."""
    left, right = tables("long", seed=17)
    conf = {"spark.rapids.sql.join.subPartition.rows": 16}
    jq, pq = both("fused", lambda s, m: join_query(
        s, m, left, right, "existence", "long", "fused"), conf)
    assert "TpuFusedStageExec" in pq.explain()
    joins.COUNTERS.reset()
    assert_same(pq.collect(), jq.collect_cpu())
    assert joins.COUNTERS.snapshot()["sub_partition_builds"] == 1


def test_sub_partition_parts_are_key_aligned():
    """Every row of a key lands in one part, whatever side it is on, and
    the parts hold every live row once."""
    left, right = tables("double", seed=19, n_right=200)
    sess = TpuSession(BASE, device="cpu")
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow, \
        batch_to_arrow
    parts = {}
    for name, t in (("left", left), ("right", right)):
        b = batch_from_arrow(t, sess.device)
        split = joins._hash_split(b, (0,), 8)
        assert sum(p.row_count() for p in split) == t.num_rows
        parts[name] = [rows(batch_to_arrow(p).select(["k"])) for p in split]
    for q in range(8):
        for other in range(8):
            if q != other:
                shared = set(parts["left"][q]) & set(parts["right"][other])
                assert shared <= {((0,),)}, (q, other)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sub_partitions_spread_a_zipped_shard(p):
    """A shard of a 4-position exchange holds the rows of one bucket,
    pmod(murmur3(keys, 42), 4) = 1. The split spreads it over all P parts;
    the JAX engine's form with its seed (42, the exchange's) would leave
    it in P / 4 parts, one for P = 2 and 4 (ROADMAP.md Queue C)."""
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.expr.base import Vec
    from spark_rapids_tpu_torch.expr.hashing import hash_vecs
    from spark_rapids_tpu_torch import types as T
    keys = np.arange(4000, dtype=np.int64)
    h42 = hash_vecs([Vec(T.LONG, torch.from_numpy(keys),
                         torch.ones(4000, dtype=torch.bool))])
    h42 = h42.to(torch.int64).numpy()
    shard = keys[h42 % 4 == 1]
    parts = joins._hash_split(batch_from_arrow(
        pa.table({"k": shard}), "cpu"), (0,), p)
    assert sum(q.row_count() for q in parts) == len(shard)
    assert min(q.row_count() for q in parts) > len(shard) / (2 * p)
    jax_parts = set(((h42 & 0xFFFFFFFF) % p)[h42 % 4 == 1].tolist())
    assert len(jax_parts) == max(p // 4, 1)


@pytest.mark.parametrize("kind", ["int", "double", "string", "decimal"])
def test_in_with_nulls(kind):
    """IN with the JAX null rule: a null value gives null, and a list that
    holds null gives null where nothing matched; as a filter and as a
    column, exact against the JAX CPU engine (no NaN in the list)."""
    left, _ = tables(kind, seed=23)
    vals = [v for v in left.column("k").to_pylist()
            if v is not None and v == v][:3]

    def q(s, m, items):
        df = s.from_arrow(left)
        return df.select("id", hit=m.In(m.col("k"), items)), \
            df.filter(m.In(m.col("k"), items))
    for items in (vals, vals + [None]):
        (jcol, jfil), (pcol, pfil) = both("broadcast",
                                          lambda s, m: q(s, m, items))
        assert_same(pcol.collect(), jcol.collect_cpu())
        assert_same(pfil.collect(), jfil.collect_cpu())


def test_in_matches_nan_as_spark_does():
    """NaN IN (NaN) is true in the port, as Spark's In compares by its
    order (NaN equals NaN); the JAX engine compares with == (ROADMAP.md,
    known differences). Held against a Python oracle of Spark's rule."""
    t = pa.table({"v": pa.array([float("nan"), 1.0, None, -0.0])})
    got = TpuSession(BASE, device="cpu").from_arrow(t).select(
        hit=PE.In(PE.col("v"), [float("nan"), 0.0])).collect()
    assert got.column("hit").to_pylist() == [True, False, None, True]


@pytest.mark.parametrize("case", ["decimal128_key", "mixed_key_types",
                                  "decimal_scales", "non_boolean_condition"])
def test_join_refusals_at_plan_time(case):
    """What the port has no column or rule for still raises at plan time,
    before any data moves."""
    sess = TpuSession(BASE, device="cpu")
    dec = [decimal.Decimal("1.00"), decimal.Decimal("2.50")]
    t = pa.table({"k": pa.array([1, 2], pa.int64()),
                  "d": pa.array(dec, pa.decimal128(7, 2))})
    left = sess.from_arrow(t)
    if case == "decimal128_key":
        right = sess.from_arrow(pa.table({"d": pa.array(
            dec, pa.decimal128(20, 2))}))
        df = left.join(right, on="d", how="full")
    elif case == "mixed_key_types":
        right = sess.from_arrow(pa.table({"k": pa.array([1.0, 2.0])}))
        df = left.join(right, on="k", how="full")
    elif case == "decimal_scales":
        right = sess.from_arrow(pa.table({"d": pa.array(
            dec, pa.decimal128(9, 3))}))
        df = left.join(right, on="d")
    else:
        df = left.join(sess.from_arrow(t), on="k",
                       condition=PE.col("k") + PE.lit(1))
    with pytest.raises(NotImplementedError):
        df.explain()
