"""chip_smoke.py's ansi phase (`ansi_phases`, its violation queries and
their numpy oracle) run on the CPU at a small size, and the violation
queries held against the JAX engine.

On the card the phase collects the decimal star reports, q65, q39a and q58
once without ANSI and once with it, each exact against its set's oracle
with equal launches of kernels A and C and the same plan, then three ANSI
queries over store_sales that must raise Spark's error on both plans and
their guarded twins, exact against `ansi_oracle`, and Queue C1's
conversions on the card against the CPU. Here the kernel wrappers take
their plain twins and a stand-in counts each call (as in
tests/test_torch_smoke_joins.py), and the query list is cut to the
decimal star's Q3 (fused joins) and Q36 (unfused, with ANSI checks in its
projects) to keep the run short.

Tolerance: exact (keys, sums, decimals as unscaled ints)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.errors import AnsiViolation as JaxAnsiViolation
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_aggregates import SIZES as AGG_SIZES  # noqa: E402
from test_torch_smoke_joins import SIZES as JOIN_SIZES  # noqa: E402
from test_torch_smoke_parquet import DIMS, MESH, _counting  # noqa: E402

CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force",
        "spark.rapids.sql.autoBroadcastJoinThreshold": 20_000}
QUERIES = (("decimal", "q3", ("one_device", "distributed")),
           ("decimal", "q36", ("one_device", "distributed")))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PARQUET_ROW_GROUP", 4_096)
    try:
        d = str(tmp_path_factory.mktemp("ansi"))
        yield {"decimal": cs.star_decimal_data(pa, d, n_sales=2_000,
                                               dims=DIMS),
               "joins": cs.join_data(pa, d, JOIN_SIZES),
               "aggs": cs.agg_data(pa, d, AGG_SIZES)}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ansi_run(data):
    """One run of ansi_phases at a small size on the CPU."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "ANSI_QUERIES", QUERIES)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        yield cs.ansi_phases(torch, pa, MESH,
                             (a, pallas_segsum.segment_sum_f64, c),
                             data["decimal"], data["joins"], data["aggs"],
                             conf=CONF, device="cpu")[0]
    finally:
        mp.undo()


def test_queries_exact_with_equal_launches(ansi_run):
    """Every query and plan ran exact both ways (the phase raises
    otherwise) with the same launches: A on the fused joins, C on the
    distributed partial aggregates; ANSI read flags only where the plan
    has checks outside a stage's other reads (Q36's projects)."""
    lines = {(ln["query"], ln["plan"]): ln for ln in ansi_run
             if "result" in ln}
    assert sorted(lines) == sorted((q, p) for _, q, plans in QUERIES
                                   for p in plans)
    for (query, plan), ln in lines.items():
        plain, ansi = ln["launches"]["plain"], ln["launches"]["ansi"]
        assert plain == ansi
        assert (plain["murmur3_rows"] > 0) == (query == "q3")
        assert (plain["segment_sum_i64"] > 0) == (plan == "distributed")
    assert lines["q3", "one_device"]["flag_reads_added"] == 0
    assert lines["q36", "one_device"]["flag_reads_added"] > 0


def test_violations_raise_and_twins_are_exact(ansi_run):
    raised = {(ln["query"], ln["plan"]): ln for ln in ansi_run
              if "raised" in ln}
    assert sorted(raised) == sorted((q, p) for q in cs.ANSI_MESSAGES
                                    for p in ("one_device", "distributed"))
    for (query, plan), ln in raised.items():
        assert ln["raised"] == cs.ANSI_MESSAGES[query]
        assert ln["twin"]["result"] == "exact"
        # distributed, the filter fuses with the partial aggregate: C
        # sums the int64 contributions whose wrap the f64 shadow detects
        assert (ln["launches"]["segment_sum_i64"] > 0) == \
            (plan == "distributed")
    c1 = ansi_run[-1]["c1_values"]
    assert c1["if"][:5] == [2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31, 0,
                            2 ** 31 - 1]


def _jax_namespace():
    m = SimpleNamespace(**{n: getattr(JE, n) for n in (
        "col", "lit", "Sum", "Max", "Cast", "CaseWhen", "If",
        "IntegralDivide")})
    m.long, m.byte = JT.LongType(), JT.ByteType()
    m.money = JT.DecimalType(*cs.MONEY)
    return m


def test_violations_against_the_jax_engine(data):
    """The same queries on the JAX package's CPU engine: each violation
    raises the message the phase expects, and each twin equals
    ansi_oracle."""
    sess = JaxSession(dict(cs.AGG_CONF, **{"spark.sql.ansi.enabled": True}))
    want = cs.ansi_oracle(pa, data["aggs"]["paths"], data["joins"]["paths"])
    qs = cs.ansi_violations(sess, _jax_namespace(), data["aggs"]["paths"],
                            data["joins"]["paths"])
    for name, (bad, twin) in qs.items():
        with pytest.raises(JaxAnsiViolation) as e:
            bad.collect_cpu()
        assert e.value.message == cs.ANSI_MESSAGES[name]
        out = twin.collect_cpu()
        assert out.sort_by(out.column_names[0]).to_pydict() == want[name]
