"""The host engine and per-operator fallback of spark_rapids_tpu_torch
against the JAX engine on the CPU, from the same seeded inputs.

Each plan turns one node off the device: an exec key
(`spark.rapids.sql.exec.Tpu...=false`), an expression key, a cast that the
JAX device rule refuses (every pair of the carried types but strings), an
ANSI date or timestamp cast, or `spark.rapids.sql.enabled=false`. The
port's explain lines (marks, node names, reasons) must equal the JAX
`Overrides` explain lines; its result must equal the JAX engine's
`collect()` and `collect_cpu()`. Where the port follows Spark's rule and
the JAX CPU engine does not (FLOAT/DOUBLE -> DECIMAL, BYTE/SHORT/INT ->
TIMESTAMP; ROADMAP.md "Known differences"), and for casts touching a
decimal of more than 18 digits (the JAX CPU engine fails on limbs), the
result is held to a Python oracle of the rule instead. The cast pairs
whose Spark rule waits for confirmation (ROADMAP.md Queue C) are held to
the JAX CPU engine on finite values: its numpy cast of a NaN, an infinity
or an out-of-range double to DATE or TIMESTAMP is platform-defined.

Also: the join, file scan and window over a decimal of more than 18
digits, which the port keeps on the device where the JAX rules tag them
(the one place its explain lines differ), test mode, explainOnly, the
stage rerun on CpuFallbackRequired, the memory layer kept out of a host
plan, and the device passes on a mixed plan (the same exec tree as the
JAX engine's).

Tolerance: exact, but f64 sums (rtol 1e-9).
"""

import decimal
import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import TpuConf, _REGISTRY
from spark_rapids_tpu_torch.cpu import hostbatch
from spark_rapids_tpu_torch.errors import AnsiViolation, CpuFallbackRequired
from spark_rapids_tpu_torch.exec.basic import TpuFilterExec
from spark_rapids_tpu_torch.expr.cast import device_supported
from spark_rapids_tpu_torch.memory.budget import MemoryBudget
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession
from spark_rapids_tpu_torch.utils.metrics import TaskMetrics

from torch_port import positional

D = decimal.Decimal
N = 600
BASE = {"spark.rapids.sql.explain": "ALL",
        "spark.rapids.sql.batchSizeRows": 256}
ANSI = {"spark.sql.ansi.enabled": True}
FUSED = {"spark.rapids.tpu.fusion.enabled": True,
         "spark.rapids.tpu.fusion.pallas.mode": "force"}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4"}


def _tables():
    rng = np.random.default_rng(71)
    null = lambda p=0.05: rng.random(N) < p  # noqa: E731
    fact = pa.table({
        "k": pa.array(rng.integers(0, 8, N), pa.int64(), mask=null()),
        "v": pa.array(rng.integers(-1000, 1000, N), pa.int64()),
        "x": pa.array(rng.normal(0, 100, N), pa.float64(), mask=null()),
        "i": pa.array(rng.integers(-50, 50, N).astype(np.int32)),
        "p": pa.array([D(int(u)).scaleb(-2) for u in
                       rng.integers(-10 ** 6, 10 ** 6, N)],
                      pa.decimal128(7, 2)),
        "s": pa.array([f"s{j % 13}" for j in range(N)])})
    dim = pa.table({"k": pa.array(np.arange(8), pa.int64()),
                    "name": pa.array([f"n{j}" for j in range(8)])})
    return fact, dim


FACT, DIM = _tables()


def _query(case, sess, m):
    """The plan of each exec-key case, written for either engine."""
    c = m.col
    f = sess.from_arrow(FACT)
    if case == "scan":
        return f.select("k", "v")
    if case == "project":
        return f.select("k", w=m.Add(c("v"), m.lit(7)))
    if case == "filter":
        return f.filter(m.GreaterThan(c("v"), m.lit(0))).select("k", "v")
    if case == "aggregate":
        return f.group_by("k").agg(n=m.Count(m.lit(1)), t=m.Sum(c("v")),
                                   hi=m.Max(c("x")), sp=m.Sum(c("p")))
    if case == "join":
        return f.select("k", "v").join(sess.from_arrow(DIM), on="k")
    if case == "sort":
        return f.select("k", "v", "i").sort("k", "v", "i")
    if case == "limit":
        return f.select("k", "v", "i").sort("v", "i").limit(25, offset=3)
    if case == "union":
        return f.select("k", "v").union(
            f.filter(m.LessThan(c("v"), m.lit(0))).select("k", "v"))
    if case == "window":
        return f.select("k", "v", "i").window(
            ["k"], ["v", "i"], rn=m.RowNumber(),
            run=m.WindowAggregate(m.Sum(c("v")), m.RowFrame(None, 0)))
    raise ValueError(case)


# the exec key each case turns off (JAX `exec_rule`: Cpu -> Tpu)
EXEC_KEYS = {"scan": "TpuScanExec", "project": "TpuProjectExec",
             "filter": "TpuFilterExec", "aggregate": "TpuHashAggregateExec",
             "join": "TpuHashJoinExec", "sort": "TpuSortExec",
             "limit": "TpuLimitExec", "union": "TpuUnionExec",
             "window": "TpuWindowExec"}
ORDERED = ("sort", "limit", "window")


def _port_lines(conf, make):
    sess = TpuSession(dict(BASE, **conf), device="cpu")
    sess.plan_device(make(sess, PE).plan)
    return sess._last_explain.splitlines()


def _jax_lines(conf, make):
    return make(JaxSession(dict(BASE, **conf)), JE).explain().splitlines()


def _same(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    got, want = positional(got, ordered), positional(want, ordered)
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        a, b = got.column(name), want.column(name)
        if pa.types.is_floating(a.type):
            np.testing.assert_allclose(
                a.to_numpy(zero_copy_only=False),
                b.to_numpy(zero_copy_only=False), rtol=1e-9)
        else:
            if pa.types.is_timestamp(b.type):
                b = b.cast(a.type)
            assert a.equals(b), name


CASES = [(case, {f"spark.rapids.sql.exec.{key}": False})
         for case, key in EXEC_KEYS.items()] + [
    ("project", {"spark.rapids.sql.expression.Add": False}),
    ("aggregate", {"spark.rapids.sql.enabled": False})]
IDS = [f"{case}-{next(iter(conf))}" for case, conf in CASES]


@pytest.mark.parametrize("case,conf", CASES, ids=IDS)
def test_explain_matches_jax(case, conf):
    make = lambda s, m: _query(case, s, m)  # noqa: E731
    got = _port_lines(conf, make)
    assert got == _jax_lines(conf, make)
    if "spark.rapids.sql.enabled" in conf:
        assert got == []
    else:
        assert sum(ln.lstrip().startswith("!") for ln in got) == 1, got


@pytest.mark.parametrize("case,conf", CASES, ids=IDS)
def test_results_match_jax(case, conf):
    sess = TpuSession(dict(BASE, **conf), device="cpu")
    got = _query(case, sess, PE).collect()
    jsess = JaxSession(dict(BASE, **conf))
    for want in (_query(case, jsess, JE).collect_cpu(),
                 _query(case, jsess, JE).collect()):
        _same(got, want, case in ORDERED)
    tm = TaskMetrics.get()
    assert tm.host_nodes_run >= 1
    if "spark.rapids.sql.enabled" in conf:
        assert tm.to_device_rows == tm.to_host_rows == 0


# a decimal(21,6) column: past the JAX join, file-scan and window rules'
# 18 digits, within the port's
LIMBS = FACT.append_column("w", pa.array(
    [None if j % 17 == 0 else D(j * 7919 - 10 ** 6).scaleb(-6) + D(10 ** 14)
     for j in range(N)], pa.decimal128(21, 6)))


def _limb_query(case, sess, m, path):
    if case == "join":
        return sess.from_arrow(LIMBS).select("k", "w").join(
            sess.from_arrow(DIM), on="k")
    if case == "window":
        return sess.from_arrow(LIMBS).select("k", "v", "i", "w").window(
            ["k"], ["v", "i"],
            f=m.WindowAggregate(m.First(m.col("w")), m.RowFrame(None, 0)))
    return sess.read_parquet(path).select("k", "w")


@pytest.mark.parametrize("case", ["join", "window", "file_scan"])
def test_limb_execs_stay_on_the_device(case, tmp_path):
    """The port's join, file-scan and window rules take the 38 digits that
    their execs compute on the device, where the JAX rules stop at 18 and
    tag the node (ROADMAP.md "Known differences": the plan differs, no
    value does). The join and the scan equal the JAX CPU engine; the
    window's limb gathers are held to a Python oracle in
    test_torch_aggregates.py, as the JAX CPU engine fails on limbs."""
    path = str(tmp_path / "limbs.parquet")
    pq.write_table(LIMBS.select(["k", "w"]), path)
    make = lambda s, m: _limb_query(case, s, m, path)  # noqa: E731
    got = _port_lines({}, make)
    jax = _jax_lines({}, make)
    assert [ln.replace("!", "*", 1).split(" <- ")[0] for ln in jax] == got
    assert not any(ln.lstrip().startswith("!") for ln in got)
    bang = [ln for ln in jax if ln.lstrip().startswith("!")]
    assert len(bang) == 1 and \
        "decimal(21,6) exceeds max supported precision 18" in bang[0]
    out = make(TpuSession(BASE, device="cpu"), PE).collect()
    assert TaskMetrics.get().host_nodes_run == 0
    if case != "window":
        _same(out, make(JaxSession(BASE), JE).collect_cpu(), False)


# --------------------------------------------------------------------------
# the casts the device refuses


_INTS = {"byte": (-128, 127), "short": (-32768, 32767),
         "integer": (-2 ** 31, 2 ** 31 - 1), "long": (-2 ** 63, 2 ** 63 - 1)}
VALUES = {
    "boolean": [True, False, None],
    "double": [-2.5, 0.125, 1e300, math.nan, math.inf, -math.inf, -0.0,
               1.005, 123.456, -0.005, None],
    "float": [-2.5, 0.125, 3e38, math.nan, math.inf, -math.inf, -0.0,
              1.005, 123.456, None],
    "date": [-719162, -1, 0, 1, 18000, None],
    "timestamp": [-1, -1_000_001, 0, 1_500_000, 1_700_000_000_123_456,
                  -60_000_000_000_000_000, None],
    "decimal(7,2)": [D("-2.50"), D("0.13"), D("99999.99"), D("-99999.99"),
                     None],
    "decimal(20,2)": [D("-2.50"), D("123456789012345678.91"), None],
}
for _t, (_lo, _hi) in _INTS.items():
    VALUES[_t] = [0, 1, -1, 86399, -86401, _lo, _hi, None]
    VALUES[_t] = [v for v in VALUES[_t] if v is None or _lo <= v <= _hi]
TYPES = list(VALUES)
HOST_CASTS = [(s, d) for s in TYPES for d in TYPES
              if s != d and not device_supported(T.parse_type(s),
                                                 T.parse_type(d))]
# device casts that the JAX planner refuses under ANSI (`_tag_cast`)
ANSI_HOST_CASTS = [("date", "integer"), ("date", "timestamp"),
                   ("timestamp", "date"), ("timestamp", "long"),
                   ("long", "timestamp")]


def _arrow_type(ts: str):
    t = T.parse_type(ts)
    if isinstance(t, T.TimestampType):
        return pa.timestamp("us", tz="UTC")
    return T.to_arrow(t)


def _cast_table(src: str, values):
    if src == "timestamp":
        arr = pa.array(values, pa.int64()).cast(_arrow_type(src))
    elif src == "date":
        arr = pa.array(values, pa.int32()).cast(pa.date32())
    else:
        arr = pa.array(values, _arrow_type(src))
    return pa.table({"a": arr, "n": pa.array(np.arange(len(values)))})


def _cast_query(src, dst, sess, m, values=None):
    tp = JT if m is JE else T
    return sess.from_arrow(_cast_table(src, values or VALUES[src])).select(
        "n", x=m.Cast(m.col("a"), tp.parse_type(dst)))


def _spark_float_to_decimal(v, p, s):
    """Spark: the shortest digits of the double, HALF_UP to scale s; null
    for NaN, the infinities and |value| >= 10^(p - s)."""
    if v is None or not math.isfinite(v):
        return None
    with decimal.localcontext(decimal.Context(prec=1000)):
        q = D(repr(float(v))).quantize(D(1).scaleb(-s),
                                       rounding=decimal.ROUND_HALF_UP)
        return None if abs(q) >= D(10) ** (p - s) else q


def _oracle(src, dst, values):
    """Spark's rule for the pairs where the port follows it; the JAX
    engine's value for casts touching a decimal of more than 18 digits
    (its CPU engine fails on limbs); None where the JAX engine is the
    oracle."""
    st, dt = T.parse_type(src), T.parse_type(dst)
    if src in ("float", "double") and isinstance(dt, T.DecimalType):
        if src == "float":
            values = [None if v is None else float(np.float32(v))
                      for v in values]
        return [_spark_float_to_decimal(v, dt.precision, dt.scale)
                for v in values]
    if src in ("byte", "short", "integer") and dst == "timestamp":
        return [None if v is None else v * 1_000_000 for v in values]
    if dst == "decimal(20,2)":  # days or microseconds as the value
        return [None if v is None else D(v) for v in values]
    if src == "decimal(20,2)":  # truncated, null past the target's range
        lo, hi = (-2 ** 31, 2 ** 31 - 1) if dst == "date" else _INTS["long"]
        out = [None if v is None else int(v) for v in values]
        return [v if v is None or lo <= v <= hi else None for v in out]
    return None


def _values(got: pa.Table, dst: str):
    col = got.sort_by("n").column("x")
    if dst == "timestamp":
        col = col.cast(pa.int64())
    elif dst == "date":
        col = col.cast(pa.int32())
    return col.to_pylist()


def _finite(src, dst):
    """Inputs whose JAX CPU result is defined: a NaN, an infinity or an
    out-of-range double has no defined int32/int64 conversion in numpy."""
    vals = VALUES[src]
    if src in ("float", "double") and dst in ("date", "timestamp"):
        vals = [v for v in vals if v is None or abs(v) < 1e9]
    return vals


@pytest.mark.parametrize("src,dst", HOST_CASTS,
                         ids=[f"{s}-{d}" for s, d in HOST_CASTS])
def test_host_cast(src, dst):
    """The explain line of the JAX tag, and the value of Spark's rule or
    of the JAX CPU engine."""
    make = lambda s, m: _cast_query(src, dst, s, m)  # noqa: E731
    lines = _port_lines({}, make)
    assert lines == _jax_lines({}, make)
    assert lines[0] == (f"! CpuProjectExec <- cast {T.parse_type(src).simple_string()}"
                        f" -> {T.parse_type(dst).simple_string()} is not "
                        "supported on TPU")
    vals = _finite(src, dst)
    got = _values(_cast_query(src, dst, TpuSession(BASE, device="cpu"), PE,
                              vals).collect(), dst)
    want = _oracle(src, dst, vals)
    if want is None:
        jq = _cast_query(src, dst, JaxSession(BASE), JE, vals)
        want = _values(jq.collect_cpu(), dst)
    assert got == want


def test_float_to_decimal_edges_follow_spark():
    """-2.5 and 0.125 to decimal(4,2) are -2.50 and 0.13 (the JAX CPU
    engine truncates to -2.00 and 0.00); 1e300, NaN and the infinities are
    null; -0.0 is 0.00."""
    vals = [-2.5, 0.125, 1e300, math.nan, math.inf, -math.inf, -0.0, None]
    got = _values(_cast_query("double", "decimal(4,2)",
                              TpuSession(BASE, device="cpu"), PE,
                              vals).collect(), "decimal(4,2)")
    assert got == [D("-2.50"), D("0.13"), None, None, None, None, D("0.00"),
                   None]
    jax = _values(_cast_query("double", "decimal(4,2)", JaxSession(BASE), JE,
                              [-2.5, 0.125]).collect_cpu(), "decimal(4,2)")
    assert jax == [D("-2.00"), D("0.00")]  # the value that differs


@pytest.mark.parametrize("bad", [1e300, math.nan, math.inf, -math.inf])
def test_float_to_decimal_raises_under_ansi(bad):
    sess = TpuSession(dict(BASE, **ANSI), device="cpu")
    with pytest.raises(AnsiViolation, match="NUMERIC_VALUE_OUT_OF_RANGE"):
        _cast_query("double", "decimal(4,2)", sess, PE, [1.5, bad]).collect()
    ok = _cast_query("double", "decimal(4,2)", sess, PE, [1.5, -2.5, None])
    assert _values(ok.collect(), "decimal(4,2)") == [D("1.50"), D("-2.50"),
                                                      None]


@pytest.mark.parametrize("src,dst", ANSI_HOST_CASTS,
                         ids=[f"{s}-{d}" for s, d in ANSI_HOST_CASTS])
def test_ansi_date_casts_run_on_the_host(src, dst):
    """Under ANSI the JAX planner sends the date and timestamp casts to its
    CPU engine; the port runs them on its host engine, with the same
    explain line and values."""
    conf = dict(BASE, **ANSI)
    make = lambda s, m: _cast_query(src, dst, s, m)  # noqa: E731
    lines = _port_lines(ANSI, make)
    assert lines == _jax_lines(ANSI, make)
    assert "ANSI-mode cast" in lines[0]
    sess = TpuSession(conf, device="cpu")
    got = _values(_cast_query(src, dst, sess, PE).collect(), dst)
    want = _values(_cast_query(src, dst, JaxSession(conf), JE).collect_cpu(),
                   dst)
    assert got == want
    assert TaskMetrics.get().host_nodes_run == 1


# --------------------------------------------------------------------------
# modes and the rerun


def test_test_mode_raises_on_a_fallback_only():
    conf = dict(BASE, **{"spark.rapids.sql.test.enabled": True})
    sess = TpuSession(conf, device="cpu")
    with pytest.raises(AssertionError, match="fell back to CPU"):
        _cast_query("double", "decimal(4,2)", sess, PE).collect()
    assert _query("aggregate", sess, PE).collect().num_rows == 9


def test_explain_only_runs_the_host_plan():
    conf = dict(BASE, **{"spark.rapids.sql.mode": "explainOnly"})
    sess = TpuSession(conf, device="cpu")
    got = _query("join", sess, PE).collect()
    tm = TaskMetrics.get()
    assert tm.host_nodes_run == 4 and tm.to_device_rows == 0
    want = _query("join", TpuSession(BASE, device="cpu"), PE).collect()
    _same(got, want, False)
    assert sess._last_explain.splitlines()[0] == "* CpuHashJoinExec"


def test_cpu_fallback_rerun(monkeypatch):
    """CpuFallbackRequired from a device exec's batch loop reruns the whole
    plan on the host engine, counted once."""
    real = TpuFilterExec.filter

    def device_refuses(self, batch):
        if not hostbatch.on_host():
            raise CpuFallbackRequired("injected")
        return real(self, batch)

    sess = TpuSession(BASE, device="cpu")
    want = _query("filter", sess, PE).collect()
    monkeypatch.setattr(TpuFilterExec, "filter", device_refuses)
    got = _query("filter", sess, PE).collect()
    assert got.equals(want)
    tm = TaskMetrics.get()
    assert tm.cpu_fallback_reruns == 1 and tm.host_nodes_run == 3


def test_a_host_plan_stays_off_the_memory_layer():
    """The host execs reserve nothing, park nothing and take no permit; the
    same plan on the device path (here on the CPU) keeps its seams."""
    for case in ("join", "aggregate", "sort", "window"):
        for enabled in (False, True):
            sess = TpuSession(dict(BASE, **{
                "spark.rapids.sql.enabled": enabled}), device="cpu")
            _query(case, sess, PE).collect()
            peak = MemoryBudget.get().peak_used
            assert (peak == 0) == (not enabled), (case, enabled, peak)
            assert not BufferCatalog.get()._entries
            assert (TaskMetrics.get().semaphore_wait_ns == 0) or enabled


def test_conf_keys_of_the_port_rules_only():
    for key in ("spark.rapids.sql.exec.TpuParquetScanExec",
                "spark.rapids.sql.exec.TpuWindowExec",
                "spark.rapids.sql.expression.Cast",
                "spark.rapids.sql.expression.WindowAggregate"):
        assert key in _REGISTRY
    for key in ("spark.rapids.sql.exec.TpuGenerateExec",
                "spark.rapids.sql.expression.Md5",
                "spark.rapids.sql.expression.CollectList"):
        assert key not in _REGISTRY
    with pytest.raises(NotImplementedError, match="adaptive"):
        Overrides(TpuConf({"spark.rapids.sql.adaptive.enabled": True}),
                  "cpu").apply(_query("scan", TpuSession(
                      device="cpu"), PE).plan)


@pytest.mark.parametrize("key", [
    "spark.rapids.sql.adaptive.enabled", "spark.rapids.tpu.stats.enabled",
    "spark.rapids.tpu.stats.feedback.enabled",
    "spark.rapids.tpu.rescache.enabled", "spark.rapids.tpu.telemetry.enabled",
    "spark.rapids.tpu.live.enabled", "spark.rapids.tpu.compile.warmup.enabled",
    "spark.rapids.tpu.compile.tuner.enabled",
    "spark.rapids.tpu.fleet.supervisor.enabled",
    "spark.rapids.tpu.metrics.profile.enabled",
    "spark.rapids.tpu.metrics.spans.kernel.enabled"])
def test_conf_keys_of_unported_modules_raise(key):
    """Each switch of a JAX module the port lacks is registered with the
    JAX default (off: the plan runs) and raises at plan time when on, as
    the JAX engine would run the module; the JAX registry holds the same
    default."""
    assert key in _REGISTRY and _REGISTRY[key].default is False
    assert JaxConf().get(key) is False
    sess = TpuSession(device="cpu")
    Overrides(TpuConf({key: False}), "cpu").apply(
        _query("scan", sess, PE).plan)
    with pytest.raises(NotImplementedError, match=key):
        Overrides(TpuConf({key: "true"}), "cpu").apply(
            _query("scan", sess, PE).plan)


def _names(tree: str):
    return [ln.strip().split("[")[0].split("(")[0]
            for ln in tree.splitlines() if ln.strip()]


@pytest.mark.parametrize("plan", ["fused", "distributed_fused"])
def test_mixed_plan_tree_matches_jax(plan):
    """A host cast between device stages: fusion walks into both bridges
    and no chain crosses one; the distribution pass runs only above the
    host node. The exec trees name the same nodes as the JAX engine's."""
    conf = dict(BASE, **FUSED, **(MESH if plan == "distributed_fused"
                                  else {}))

    def make(sess, m, cast=True):
        tp = JT if m is JE else T
        c = m.col
        f = sess.from_arrow(FACT).filter(m.GreaterThan(c("v"), m.lit(-900)))
        q = f.join(sess.from_arrow(DIM), on="k") \
            .group_by("name").agg(a=m.Average(c("v")))
        if cast:
            q = q.select("name", a=m.Cast(c("a"), tp.DecimalType(7, 2)))
        return q.sort("name").limit(5)

    sess = TpuSession(conf, device="cpu")
    port = sess.plan_device(make(sess, PE).plan).tree_string()
    jax = JaxOverrides(JaxConf(conf)).apply(
        make(JaxSession(conf), JE).plan).tree_string()
    assert _names(port) == _names(jax), (port, jax)
    assert "TpuFromCpuExec" in port and "TpuFusedStageExec" in port
    got = make(sess, PE).collect()
    # Spark's rule over the JAX engine's averages (its own cast truncates)
    want = make(JaxSession(conf), JE, cast=False).collect_cpu()
    assert got.column("name").equals(want.column("name"))
    assert got.column("a").to_pylist() == [
        _spark_float_to_decimal(v, 7, 2) for v in want.column("a").to_pylist()]
