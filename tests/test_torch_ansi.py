"""ANSI mode in spark_rapids_tpu_torch against the JAX engine on the CPU,
from the same inputs (the cases of tests/test_ansi.py and
tests/test_fusion.py::TestAnsiParity that the port's types and execs
cover).

Each case either gives the same result in both engines, or raises
AnsiViolation in both with the same message. The classes are distinct
(`spark_rapids_tpu.errors.AnsiViolation` and
`spark_rapids_tpu_torch.errors.AnsiViolation`), so outcomes compare by
class name and message. Expressions are evaluated alone on one padded
batch, the JAX side eagerly on jax.numpy (the device engine's arithmetic,
with its error flags raised after the batch); plans run through both
sessions, the JAX side on its CPU engine (`collect_cpu()`, which raises
where the first violation occurs), a few on its device engine. The port
runs each plan on one device, distributed (4 mesh positions) where the
case has that plan, and fused against unfused.

Left out: the string casts, generate and expand, which the port does not
have; an ANSI string cast is refused at plan time, as without ANSI.

Tolerance: exact, every column (a NaN equals a NaN).
"""

import decimal
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exec.base import raise_eager_errors
from spark_rapids_tpu.expr.base import BoundReference as JBound, \
    EvalContext as JCtx, Vec as JVec
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import AnsiViolation
from spark_rapids_tpu_torch.exec import base as exec_base
from spark_rapids_tpu_torch.expr.base import BoundReference, EvalContext, Vec
from spark_rapids_tpu_torch.plugin import TpuSession

D = decimal.Decimal
BASE = {"spark.rapids.sql.explain": "NONE"}
ANSI = dict(BASE, **{"spark.sql.ansi.enabled": True})
FUSED = {"spark.rapids.tpu.fusion.enabled": True,
         "spark.rapids.tpu.fusion.pallas.mode": "force"}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1}
PLANS = {"one_device": {}, "distributed": MESH, "fused": FUSED,
         "distributed_fused": dict(MESH, **FUSED)}
_NAMES = ("col lit Add Subtract Multiply Divide IntegralDivide Remainder "
          "Pmod UnaryMinus Abs Cast If CaseWhen Coalesce Least Greatest "
          "IsNotNull EqualTo LessThan GreaterThan Sum Count Max "
          "RowNumber").split()
JNS = SimpleNamespace(**{n: getattr(JE, n) for n in _NAMES}, T=JT)
PNS = SimpleNamespace(**{n: getattr(PE, n) for n in _NAMES}, T=T)
L = lambda *v: pa.array(v, pa.int64())
I = lambda *v: pa.array(v, pa.int32())

INF, NAN = float("inf"), float("nan")


# --------------------------------------------------------------------------
# one expression on one padded batch


def _columns(args, cap):
    """args: [(type string, values with None for null)] -> per column
    (type string, data padded to cap with a value that would raise,
    validity)."""
    out = []
    for ts, values in args:
        pt = T.parse_type(ts)
        # padding rows are valid, as a compacted batch's tail may be: only
        # the row mask keeps them from raising
        valid = np.ones(cap, bool)
        valid[:len(values)] = [v is not None for v in values]
        if isinstance(pt, T.DecimalType) and pt.precision > 18:
            data = np.zeros((cap, 2), np.int64)
            for i, v in enumerate(values):
                u = 0 if v is None else int(D(v).scaleb(pt.scale))
                data[i] = [u >> 64, (u & (2 ** 64 - 1)) - 2 ** 64
                           if u & (2 ** 63) else u & (2 ** 64 - 1)]
        else:
            np_t = np.int64 if isinstance(pt, T.DecimalType) else pt.np_dtype
            data = np.zeros(cap, np_t)
            for i, v in enumerate(values):
                if v is not None:
                    data[i] = int(D(v).scaleb(pt.scale)) \
                        if isinstance(pt, T.DecimalType) else v
            # padding rows hold the type's minimum: -MIN, MIN * -1 and
            # division by the row's neighbours overflow there
            if not isinstance(pt, T.DecimalType) and \
                    np.issubdtype(np_t, np.integer):
                data[len(values):] = np.iinfo(np_t).min
        out.append((ts, data, valid))
    return out


def evaluate(make, args, ansi=True, live=None):
    """make(namespace, [bound refs]) -> an expression of either engine.
    args: [(type string, values)]; the batch has capacity 8, rows past the
    values are padding, and `live` (default: every value's row) is the row
    mask. Returns per engine ("ok", data, validity) over the live rows or
    ("raise", class name, message)."""
    n = len(args[0][1])
    cap = 8
    mask = np.zeros(cap, bool)
    mask[:n] = True if live is None else live
    cols = _columns(args, cap)
    jrefs = [JBound(i, JT.parse_type(ts)) for i, (ts, _, _) in
             enumerate(cols)]
    prefs = [BoundReference(i, T.parse_type(ts)) for i, (ts, _, _) in
             enumerate(cols)]
    jvecs = [JVec(JT.parse_type(ts), jnp.asarray(d), jnp.asarray(v))
             for ts, d, v in cols]
    pvecs = [Vec(T.parse_type(ts), torch.from_numpy(d.copy()),
                 torch.from_numpy(v.copy())) for ts, d, v in cols]
    out = []
    try:
        jctx = JCtx(jnp, ansi=ansi, row_mask=jnp.asarray(mask), errors=[])
        jv = make(JNS, jrefs).eval(jctx, jvecs)
        raise_eager_errors(jctx)
        out.append(("ok", np.asarray(jv.data)[mask],
                    np.asarray(jv.validity)[mask]))
    except Exception as e:  # noqa: BLE001 -- compared with the port's
        out.append(("raise", type(e).__name__, str(e)))
    try:
        pctx = EvalContext(torch.from_numpy(mask), ansi)
        pv = make(PNS, prefs).eval(pctx, pvecs)
        exec_base.check_errors(pctx.errors)
        out.append(("ok", pv.data.numpy()[mask], pv.validity.numpy()[mask]))
    except Exception as e:  # noqa: BLE001
        out.append(("raise", type(e).__name__, str(e)))
    return out


def assert_same_outcome(jax_out, port_out, expect=None):
    """Same class name and message, or the same values where valid.
    `expect`: "ok", or the message both must raise."""
    assert jax_out[0] == port_out[0], (jax_out, port_out)
    if jax_out[0] == "raise":
        assert jax_out[1:] == port_out[1:], (jax_out, port_out)
        assert jax_out[1] == "AnsiViolation", jax_out
        if expect is not None:
            assert jax_out[2] == expect, jax_out
        return
    assert expect in (None, "ok"), (expect, port_out)
    _, jd, jv = jax_out
    _, pd, pv = port_out
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pd[pv], jd[jv])


# --------------------------------------------------------------------------
# Queue C1: float -> integer outside Cast


C1_X = [1e300, INF, -INF, NAN, 3e9]
C1_CASES = {
    "if": lambda m, r: m.If(m.IsNotNull(r[0]), m.lit(-3), r[1]),
    "case_when": lambda m, r: m.CaseWhen([(m.IsNotNull(r[0]), m.lit(-3))],
                                         r[1]),
    "coalesce": lambda m, r: m.Coalesce(r[0], r[1]),
    "greatest": lambda m, r: m.Greatest(r[2], r[1]),
    "least": lambda m, r: m.Least(r[2], r[1]),
    "integral_divide": lambda m, r: m.IntegralDivide(r[1], m.lit(1.0)),
}


@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_float_to_integer_outside_cast_matches_jax(case):
    """A DOUBLE operand of an INT or LONG result converts by Java's rule:
    clamp to the range, NaN to 0 (Queue C1's inputs, non-ANSI)."""
    jax_out, port_out = evaluate(
        C1_CASES[case],
        [("integer", [None] * 5), ("double", C1_X), ("integer", [1] * 5)],
        ansi=False)
    assert_same_outcome(jax_out, port_out, "ok")


# --------------------------------------------------------------------------
# expressions under ANSI


A_CASES = {
    # name: (make, args, live rows or None, expected message or "ok")
    "add_long": (lambda m, r: m.Add(r[0], r[0]),
                 [("long", [2 ** 62, 1])], None,
                 "[ARITHMETIC_OVERFLOW] long overflow"),
    "subtract_long": (lambda m, r: m.Subtract(r[0], m.lit(1)),
                      [("long", [-2 ** 63, 0])], None,
                      "[ARITHMETIC_OVERFLOW] long overflow"),
    "multiply_long": (lambda m, r: m.Multiply(r[0], r[0]),
                      [("long", [2 ** 32, 3])], None,
                      "[ARITHMETIC_OVERFLOW] long overflow"),
    "multiply_min_by_minus_one": (
        lambda m, r: m.Multiply(r[0], r[1]),
        [("long", [-2 ** 63, 4]), ("long", [-1, 5])], None,
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "multiply_int": (lambda m, r: m.Multiply(r[0], r[0]),
                     [("integer", [50000, 3])], None,
                     "[ARITHMETIC_OVERFLOW] integer overflow"),
    "add_byte": (lambda m, r: m.Add(r[0], r[0]),
                 [("byte", [100, 1])], None,
                 "[ARITHMETIC_OVERFLOW] tinyint overflow"),
    "subtract_short": (lambda m, r: m.Subtract(r[0], r[1]),
                       [("short", [-30000, 5]), ("short", [10000, 1])],
                       None, "[ARITHMETIC_OVERFLOW] smallint overflow"),
    "no_overflow": (lambda m, r: m.Multiply(m.Add(r[0], m.lit(1)), r[1]),
                    [("long", [2 ** 61, -5, None]),
                     ("long", [3, 2 ** 60, 7])], None, "ok"),
    "null_inputs": (lambda m, r: m.Add(r[0], r[1]),
                    [("long", [2 ** 62, None]), ("long", [None, 2 ** 62])],
                    None, "ok"),
    "decimal_add": (lambda m, r: m.Add(r[0], r[0]),
                    [("decimal(38,0)", ["6" + "0" * 37, "1"])], None,
                    "[ARITHMETIC_OVERFLOW] decimal(38,0) overflow"),
    "decimal_subtract_ok": (lambda m, r: m.Subtract(r[0], r[1]),
                            [("decimal(7,2)", ["99999.99", "-1.50"]),
                             ("decimal(7,2)", ["-99999.99", None])], None,
                            "ok"),
    "divide_by_zero": (lambda m, r: m.Divide(r[0], r[1]),
                       [("double", [1.0, 2.0]), ("double", [2.0, 0.0])],
                       None, "[DIVIDE_BY_ZERO] Division by zero"),
    "integral_divide_by_zero": (lambda m, r: m.IntegralDivide(r[0], r[1]),
                                [("long", [5, 6]), ("long", [1, 0])],
                                None, "[DIVIDE_BY_ZERO] Division by zero"),
    "integral_divide_min": (lambda m, r: m.IntegralDivide(r[0], r[1]),
                            [("long", [-2 ** 63, 8]), ("long", [-1, 2])],
                            None, "[ARITHMETIC_OVERFLOW] long overflow"),
    "remainder_by_zero": (lambda m, r: m.Remainder(r[0], r[1]),
                          [("integer", [5, 7]), ("integer", [0, 2])], None,
                          "[DIVIDE_BY_ZERO] Division by zero"),
    "pmod_by_zero": (lambda m, r: m.Pmod(r[0], r[1]),
                     [("double", [5.0, 7.0]), ("double", [2.0, 0.0])], None,
                     "[DIVIDE_BY_ZERO] Division by zero"),
    "unary_minus_min": (lambda m, r: m.UnaryMinus(r[0]),
                        [("long", [-2 ** 63])], None,
                        "[ARITHMETIC_OVERFLOW] long overflow"),
    "abs_min": (lambda m, r: m.Abs(r[0]), [("short", [-32768, 4])], None,
                "[ARITHMETIC_OVERFLOW] smallint overflow"),
    # the padding rows hold MIN: a masked row never raises
    "padding_tail": (lambda m, r: m.Add(m.Abs(r[0]), m.IntegralDivide(
        m.UnaryMinus(r[0]), r[1])), [("long", [3, 2 ** 62, 4]),
                                     ("long", [1, 0, 2])],
        [True, False, True], "ok"),
    # casts
    "double_to_int": (lambda m, r: m.Cast(r[0], m.T.INT),
                      [("double", [1e20, 1.0])], None,
                      "[CAST_OVERFLOW] casting double to integer causes "
                      "overflow"),
    "nan_to_long": (lambda m, r: m.Cast(r[0], m.T.LONG),
                    [("double", [NAN])], None,
                    "[CAST_OVERFLOW] casting double to long causes "
                    "overflow"),
    "float_to_byte": (lambda m, r: m.Cast(r[0], m.T.BYTE),
                      [("float", [127.9, -129.0])], None,
                      "[CAST_OVERFLOW] casting float to byte causes "
                      "overflow"),
    "long_to_int": (lambda m, r: m.Cast(r[0], m.T.INT),
                    [("long", [2 ** 40, 7])], None,
                    "[CAST_OVERFLOW] casting long to integer causes overflow"),
    "in_range_casts": (lambda m, r: m.Add(m.Cast(r[0], m.T.INT),
                                          m.Cast(r[1], m.T.SHORT)),
                       [("double", [1.9, -2.9, None]),
                        ("long", [-32768, 32767, 5])], None, "ok"),
    "decimal_rescale": (lambda m, r: m.Cast(r[0], m.T.DecimalType(6, 3)),
                        [("decimal(6,1)", ["99999.5"])], None,
                        "[NUMERIC_VALUE_OUT_OF_RANGE] value out of range "
                        "for decimal(6,3)"),
    "decimal_to_int": (lambda m, r: m.Cast(r[0], m.T.INT),
                       [("decimal(13,2)", ["99999999999.00"])], None,
                       "[CAST_OVERFLOW] value cannot be cast to integer due "
                       "to an overflow"),
    "decimal128_to_long_2pow63": (
        lambda m, r: m.Cast(r[0], m.T.LONG),
        [("decimal(20,0)", [str(2 ** 63)])], None,
        "[CAST_OVERFLOW] value cannot be cast to long due to an "
        "overflow"),
    "decimal_near_boundary": (
        lambda m, r: m.Add(m.Cast(r[0], m.T.LONG), m.Cast(r[1], m.T.LONG)),
        [("decimal(18,0)", ["999999999999999999"]),
         ("decimal(20,0)", [str(2 ** 63 - 512 - 10 ** 18)])], None, "ok"),
    "decimal_to_boolean": (
        lambda m, r: m.If(m.Cast(r[0], m.T.BOOLEAN), m.Cast(r[1],
                                                            m.T.BOOLEAN),
                          m.lit(None, m.T.BOOLEAN)),
        [("decimal(10,2)", ["1.50", "0.00", None]),
         ("decimal(25,0)", [str(2 ** 70), "0", None])], None, "ok"),
    "long_to_decimal": (lambda m, r: m.Cast(r[0], m.T.DecimalType(10, 2)),
                        [("long", [7, 10 ** 8])], None,
                        "[NUMERIC_VALUE_OUT_OF_RANGE] value out of range "
                        "for decimal(10,2)"),
    "decimal_casts_ok": (lambda m, r: m.Cast(m.Cast(r[0], m.T.DecimalType(
        12, 4)), m.T.INT), [("decimal(10,2)", ["12.50", None])], None, "ok"),
    # lazy branches
    "if_guarded_division": (
        lambda m, r: m.If(m.EqualTo(r[1], m.lit(0)),
                          m.lit(None, m.T.DOUBLE), m.Divide(r[0], r[1])),
        [("long", [10, 10]), ("long", [0, 2])], None, "ok"),
    "case_when_guarded_overflow": (
        lambda m, r: m.CaseWhen([(m.LessThan(r[0], m.lit(100)),
                                  m.Add(r[0], r[0]))], m.lit(-1, m.T.LONG)),
        [("long", [2 ** 62, 5])], None, "ok"),
    "if_unguarded_branch": (
        lambda m, r: m.If(m.EqualTo(r[1], m.lit(99)),
                          m.lit(None, m.T.DOUBLE), m.Divide(r[0], r[1])),
        [("long", [10]), ("long", [0])], None,
        "[DIVIDE_BY_ZERO] Division by zero"),
    "nested_case_narrows_again": (
        lambda m, r: m.CaseWhen(
            [(m.GreaterThan(r[1], m.lit(0)),
              m.CaseWhen([(m.LessThan(r[0], m.lit(100)),
                           m.Multiply(r[0], r[0]))],
                         m.IntegralDivide(r[0], m.Subtract(r[1],
                                                           m.lit(1)))))],
            m.Cast(r[0], m.T.INT)),
        [("long", [2 ** 40, 7, 2 ** 35, 9]), ("long", [5, 1, 0, 3])],
        None, "[CAST_OVERFLOW] casting long to integer causes overflow"),
    "case_when_later_branch_raises": (
        lambda m, r: m.CaseWhen([(m.LessThan(r[0], m.lit(0)), m.lit(0)),
                                 (m.LessThan(r[0], m.lit(100)),
                                  m.Cast(m.Multiply(r[0], m.lit(10 ** 9)),
                                         m.T.INT))],
                                m.Cast(r[0], m.T.INT)),
        [("long", [-5, 50, 2 ** 20])], None,
        "[CAST_OVERFLOW] casting long to integer causes overflow"),
}


@pytest.mark.parametrize("case", sorted(A_CASES))
def test_expression_matches_jax(case):
    make, args, live, expect = A_CASES[case]
    jax_out, port_out = evaluate(make, args, live=live)
    assert_same_outcome(jax_out, port_out, expect)


def test_first_violation_in_evaluation_order():
    """Two violations in one batch: both engines raise the one evaluated
    first, not the one in the first row."""
    make = lambda m, r: m.Add(m.IntegralDivide(r[1], r[2]),
                              m.Multiply(r[0], r[0]))
    jax_out, port_out = evaluate(make, [("long", [2 ** 40, 1]),
                                        ("long", [1, 1]),
                                        ("long", [1, 0])])
    assert_same_outcome(jax_out, port_out,
                        "[DIVIDE_BY_ZERO] Division by zero")


# --------------------------------------------------------------------------
# plans: the port's session against the JAX engine's


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 -- compared across engines
        return "raise", type(e).__name__, str(e)


def _sorted_rows(t: pa.Table):
    return sorted(t.to_pylist(), key=lambda r: [(v is None, str(v))
                                                for v in r.values()])


def run_both(build, tables, plan="one_device", jax_device=False,
             conf=None):
    """build(namespace, {name: DataFrame}) -> DataFrame, in both engines
    over the same Arrow tables; (JAX outcome, port outcome)."""
    conf = dict(ANSI, **(conf or {}))
    js = JaxSession(conf)
    ps = TpuSession(dict(conf, **PLANS[plan]), device="cpu")
    jq = build(JNS, {k: js.from_arrow(t) for k, t in tables.items()})
    pq = build(PNS, {k: ps.from_arrow(t) for k, t in tables.items()})
    j = _outcome(jq.collect if jax_device else jq.collect_cpu)
    p = _outcome(pq.collect)
    return j, p


def assert_same_plan_outcome(j, p, expect):
    assert j[0] == p[0], (j, p)
    if j[0] == "raise":
        assert j[1:] == p[1:] == ("AnsiViolation", expect), (j, p)
        return
    assert expect == "ok", (expect, p)
    assert j[1].column_names == p[1].column_names
    assert _sorted_rows(j[1]) == _sorted_rows(p[1]), (j[1], p[1])


KV = pa.table({"k": I(1, 1, 2, 2, 3), "a": L(5, 2 ** 62, 7, -3, 9),
               "b": L(1, 2, 0, 4, 5)})
P_CASES = {
    # name: (build, tables, plans, expected)
    "filter_condition": (
        lambda m, d: d["t"].filter(m.GreaterThan(m.Add(m.col("a"),
                                                       m.col("a")),
                                                 m.lit(0))),
        {"t": KV}, ("one_device", "fused"),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "filter_then_project_padding_tail": (
        lambda m, d: d["t"].filter(m.LessThan(m.col("a"), m.lit(10)))
        .select(x=m.Add(m.col("a"), m.col("a")),
                y=m.IntegralDivide(m.col("a"), m.col("k"))),
        {"t": KV}, ("one_device", "fused"), "ok"),
    "project_guarded_case": (
        lambda m, d: d["t"].select(
            k=m.col("k"),
            x=m.CaseWhen([(m.GreaterThan(m.col("b"), m.lit(0)),
                           m.IntegralDivide(m.col("a"), m.col("b")))])),
        {"t": KV}, ("one_device", "fused"), "ok"),
    "cast_in_agg_ok": (
        lambda m, d: d["t"].filter(m.LessThan(m.col("a"), m.lit(100)))
        .group_by("k").agg(s=m.Sum(m.Cast(m.col("a"), m.T.INT))),
        {"t": KV}, ("one_device", "distributed", "distributed_fused"), "ok"),
    "cast_in_agg_raises": (
        lambda m, d: d["t"].group_by("k").agg(
            s=m.Sum(m.Cast(m.col("a"), m.T.INT))),
        {"t": KV}, ("one_device", "distributed", "distributed_fused"),
        "[CAST_OVERFLOW] casting long to integer causes overflow"),
    "sum_accumulator_overflow": (
        lambda m, d: d["t"].group_by("k").agg(s=m.Sum(m.col("a")),
                                              n=m.Count(None)),
        {"t": pa.table({"k": I(1, 1, 2), "a": L(2 ** 63 - 1, 2 ** 63 - 1,
                                                 4)})},
        ("one_device", "distributed", "distributed_fused"),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "sum_of_ints_no_overflow": (
        lambda m, d: d["t"].group_by("k").agg(s=m.Sum(m.col("i")),
                                              x=m.Sum(m.Add(m.col("a"),
                                                            m.lit(1)))),
        {"t": pa.table({"k": I(1, 1, 2), "i": I(2 ** 31 - 1, 2 ** 31 - 1, 4),
                        "a": L(2 ** 62, 2 ** 62 - 3, -7)})},
        ("one_device", "distributed", "distributed_fused"), "ok"),
    # both engines null a decimal sum past 38 digits under ANSI; Spark's
    # ANSI Sum raises there (ROADMAP.md Queue C, to confirm)
    "decimal_sum_past_38_digits": (
        lambda m, d: d["t"].group_by("k").agg(s=m.Sum(m.col("d"))),
        {"t": pa.table({"k": L(1, 1, 2), "d": pa.array(
            [D("6" + "0" * 37)] * 2 + [D(1)], pa.decimal128(38, 0))})},
        ("one_device", "distributed"), "ok"),
    "global_sum_overflow": (
        lambda m, d: d["t"].agg(s=m.Sum(m.col("a"))),
        {"t": pa.table({"a": L(2 ** 62, 2 ** 62, 2 ** 62, -5)})},
        ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "agg_arithmetic_overflow": (
        lambda m, d: d["t"].group_by("k").agg(
            s=m.Sum(m.Add(m.col("a"), m.col("a")))),
        {"t": KV}, ("one_device", "distributed_fused"),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "sort_key_overflow": (
        lambda m, d: d["t"].sort(m.Add(m.col("a"), m.col("a"))),
        {"t": KV}, ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "sort_key_ok": (
        lambda m, d: d["t"].sort(m.Add(m.col("b"), m.lit(1))),
        {"t": KV}, ("one_device",), "ok"),
    "topk_key_overflow": (
        lambda m, d: d["t"].sort(m.Add(m.col("a"), m.col("a"))).limit(1),
        {"t": KV}, ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "window_order_key_overflow": (
        lambda m, d: d["t"].window(
            partition_by=["k"], order_by=[(m.Add(m.col("a"), m.col("a")),
                                           True, True)],
            rn=m.RowNumber()),
        {"t": KV}, ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "window_input_overflow": (
        lambda m, d: d["t"].window(partition_by=["k"],
                                   s=m.Sum(m.Multiply(m.col("a"),
                                                      m.lit(4)))),
        {"t": KV}, ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "window_ok": (
        lambda m, d: d["t"].window(partition_by=["k"],
                                   s=m.Sum(m.Add(m.col("b"), m.lit(1)))),
        {"t": KV}, ("one_device",), "ok"),
    "join_condition_overflow": (
        lambda m, d: d["l"].join(d["r"], on="k", condition=m.GreaterThan(
            m.Add(m.col("a"), m.col("a")), m.col("b"))),
        {"l": pa.table({"k": L(1, 2), "a": L(2 ** 62, 1)}),
         "r": pa.table({"k": L(1, 2), "b": L(1, 2)})},
        ("one_device", "distributed", "fused"),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "join_condition_nonmatching_pairs": (
        lambda m, d: d["l"].join(d["r"], on="k", how="left",
                                 condition=m.GreaterThan(
                                     m.Add(m.col("a"), m.col("a")),
                                     m.col("b"))),
        {"l": pa.table({"k": L(1, 99), "a": L(5, 2 ** 62)}),
         "r": pa.table({"k": L(1, 2), "b": L(1, 2)})},
        ("one_device", "distributed", "fused"), "ok"),
    "nested_loop_condition_overflow": (
        lambda m, d: d["l"].join(d["r"], condition=m.GreaterThan(
            m.Add(m.col("a"), m.col("a")), m.col("b"))),
        {"l": pa.table({"a": L(1, 2 ** 62)}), "r": pa.table({"b": L(1)})},
        ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "nested_loop_semi_condition_overflow": (
        lambda m, d: d["l"].join(d["r"], how="semi", condition=m.GreaterThan(
            m.Multiply(m.col("a"), m.col("b")), m.lit(0))),
        {"l": pa.table({"a": L(1, 2 ** 62)}), "r": pa.table({"b": L(1, 2)})},
        ("one_device",), "[ARITHMETIC_OVERFLOW] long overflow"),
    "nested_loop_condition_ok": (
        lambda m, d: d["l"].join(d["r"], how="left", condition=m.GreaterThan(
            m.Multiply(m.col("a"), m.col("b")), m.lit(3))),
        {"l": pa.table({"a": L(1, 2, 3)}), "r": pa.table({"b": L(1, 2)})},
        ("one_device",), "ok"),
}
P_PARAMS = [(case, plan) for case in sorted(P_CASES)
            for plan in P_CASES[case][2]]


@pytest.mark.parametrize("case,plan", P_PARAMS)
def test_plan_matches_jax(case, plan):
    build, tables, _, expect = P_CASES[case]
    j, p = run_both(build, tables, plan)
    assert_same_plan_outcome(j, p, expect)


# --------------------------------------------------------------------------
# violations in a second batch (batches of 4 rows), merge passes


TWO_BATCHES = {"spark.rapids.sql.batchSizeRows": 4}
B_TABLE = pa.table({"k": I(1, 1, 2, 2, 1, 2, 3, 1),
                    "a": L(1, 2, 3, 4, 5, 2 ** 62, 7, 8)})
B_CASES = {
    "project_second_batch": (
        lambda m, d: d["t"].select(x=m.Add(m.col("a"), m.col("a"))),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "merge_pass_second_batch": (
        lambda m, d: d["t"].group_by("k").agg(
            s=m.Sum(m.Add(m.col("a"), m.col("a")))),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "merge_pass_ok": (
        lambda m, d: d["t"].filter(m.LessThan(m.col("a"), m.lit(100)))
        .group_by("k").agg(s=m.Sum(m.Add(m.col("a"), m.col("a")))),
        "ok"),
    "merge_pass_accumulator": (
        lambda m, d: d["t"].group_by("k").agg(
            s=m.Sum(m.Multiply(m.col("a"), m.lit(2 ** 60)))),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "sort_second_batch": (
        lambda m, d: d["t"].sort(m.Multiply(m.col("a"), m.col("a"))),
        "[ARITHMETIC_OVERFLOW] long overflow"),
    "topk_second_batch": (
        lambda m, d: d["t"].sort(m.Multiply(m.col("a"), m.col("a")))
        .limit(2), "[ARITHMETIC_OVERFLOW] long overflow"),
}


@pytest.mark.parametrize("case,plan", [(c, p) for c in sorted(B_CASES)
                                       for p in ("one_device", "fused")])
def test_second_batch_matches_jax(case, plan):
    build, expect = B_CASES[case]
    j, p = run_both(build, {"t": B_TABLE}, plan, conf=TWO_BATCHES)
    assert_same_plan_outcome(j, p, expect)


def test_merge_pass_overflow_only_after_merge():
    """Each batch's partial sum fits; only the merge of the two passes
    2^63, so the merge pass's accumulator check raises."""
    t = pa.table({"k": I(1, 1, 1, 1, 1, 1, 1, 1),
                  "a": L(*([2 ** 60] * 8))})
    j, p = run_both(lambda m, d: d["t"].group_by("k").agg(s=m.Sum(
        m.col("a"))), {"t": t}, conf=TWO_BATCHES)
    assert_same_plan_outcome(j, p, "[ARITHMETIC_OVERFLOW] long overflow")


# --------------------------------------------------------------------------
# fusion: per-member boxes, stream order, the capacity rerun


def test_fused_error_message_matches_unfused():
    """tests/test_fusion.py::TestAnsiParity, with the JAX device engine's
    fused and unfused stages beside the port's."""
    t = pa.table({"a": L(4, 0, 7), "b": L(2, 3, 9)})
    msgs = []
    for extra in ({}, {"spark.rapids.tpu.fusion.enabled": True}):
        for sess in (JaxSession(dict(ANSI, **extra)),
                     TpuSession(dict(ANSI, **extra), device="cpu")):
            m = JNS if isinstance(sess, JaxSession) else PNS
            q = sess.from_arrow(t).filter(m.GreaterThan(m.col("b"),
                                                        m.lit(0))) \
                .select(x=m.Divide(m.lit(10), m.col("a")))
            if extra and m is PNS:
                assert "TpuFusedStageExec" in q.explain()
            msgs.append(_outcome(q.collect)[1:])
    assert msgs == [("AnsiViolation",
                     "[DIVIDE_BY_ZERO] Division by zero")] * 4, msgs


def test_fused_no_error_when_clean():
    t = pa.table({"a": L(4, 2, 7)})
    sess = TpuSession(dict(ANSI, **FUSED), device="cpu")
    q = sess.from_arrow(t).filter(PE.col("a") > PE.lit(1)) \
        .select(x=PE.Divide(PE.lit(8), PE.col("a")))
    assert "TpuFusedStageExec" in q.explain()
    assert q.collect().column("x").to_pylist() == [2.0, 4.0, 8 / 7]


def _join_chain(m, d):
    """project (a div b) -> broadcast join (each key 40 times) -> project
    (a * 2^40): two members that raise different messages, in stream
    order, with a join whose slot total outgrows the first capacity."""
    return d["f"].select(k=m.col("k"), a=m.col("a"),
                         q=m.IntegralDivide(m.col("a"), m.col("b"))) \
        .join(d["dim"], on="k") \
        .select(k=m.col("k"), z=m.Multiply(m.col("a"), m.lit(2 ** 40)),
                q=m.col("q"), w=m.col("w"))


def _chain_tables(a, b):
    n = len(a)
    return {"f": pa.table({"k": L(*[i % 3 for i in range(n)]), "a": L(*a),
                           "b": L(*b)}),
            "dim": pa.table({"k": L(*[i % 3 for i in range(120)]),
                             "w": L(*range(120))})}


@pytest.mark.parametrize("case,expect", [
    ("clean", "ok"),
    ("second_member", "[ARITHMETIC_OVERFLOW] long overflow"),
    ("both_members", "[DIVIDE_BY_ZERO] Division by zero"),
])
@pytest.mark.parametrize("plan", ["one_device", "fused"])
def test_fused_chain_stream_order_and_rerun(case, expect, plan):
    n = 100
    a = [i + 1 for i in range(n)]
    b = [1] * n
    if case != "clean":
        a[70] = 2 ** 30  # a * 2^40 overflows in the last member
    if case == "both_members":
        b[90] = 0  # a later row, but the first member
    sess = TpuSession(dict(ANSI, **PLANS[plan]), device="cpu")
    q = _join_chain(PNS, {k: sess.from_arrow(t) for k, t in
                          _chain_tables(a, b).items()})
    if plan == "fused":
        tree = q.explain()
        assert "TpuFusedStageExec" in tree and "BroadcastHashJoin[inner" \
            in tree, tree
    j, p = run_both(_join_chain, _chain_tables(a, b), plan)
    assert_same_plan_outcome(j, p, expect)


def test_fused_rerun_drops_the_discarded_run_flags(monkeypatch):
    """A join that outgrows its first capacity reruns the members up to
    it; the stage raises from the kept run only (and reads each run's
    flags with its totals: no read of its own)."""
    from spark_rapids_tpu_torch.exec import fused
    sess = TpuSession(dict(ANSI, **FUSED), device="cpu")
    tables = _chain_tables([i + 1 for i in range(100)], [1] * 100)
    q = _join_chain(PNS, {k: sess.from_arrow(t) for k, t in tables.items()})
    runs = []
    real = fused.TpuFusedStageExec._run_chain

    def run_chain(self, members, batch, builds=(), caps=()):
        out, totals, errors = real(self, members, batch, builds, caps)
        if totals:
            runs.append(caps)
            if len(runs) == 1:  # a flag set in the run that is discarded
                errors = errors + [(torch.tensor(True), "discarded")]
        return out, totals, errors

    monkeypatch.setattr(fused.TpuFusedStageExec, "_run_chain", run_chain)
    exec_base.COUNTERS.reset()
    got = q.collect()
    assert len(runs) == 2 and runs[1][0] > runs[0][0], runs
    assert got.num_rows == 100 * 40
    assert exec_base.COUNTERS.snapshot() == {"flag_reads": 0}


def test_ansi_and_plain_fuse_alike():
    """A fused star query plans the same tree under ANSI: the only
    difference is the join members' ansi flag in the stage signature."""
    fact = pa.table({"d": L(1, 2, 3, 1), "s": L(1, 1, 2, 2),
                     "p": pa.array([D("1.50"), D("2.25"), None, D("3.00")],
                                   pa.decimal128(7, 2))})
    dates = pa.table({"d": L(1, 2, 3), "y": I(2000, 2001, 2000)})
    stores = pa.table({"s": L(1, 2), "st": pa.array(["TN", "CA"])})
    trees = []
    for conf in (BASE, ANSI):
        conf = dict(conf, **FUSED, **MESH)
        conf["spark.rapids.sql.autoBroadcastJoinThreshold"] = 10 ** 6
        sess = TpuSession(conf, device="cpu")
        m = PNS
        q = sess.from_arrow(fact) \
            .join(sess.from_arrow(dates).filter(
                m.EqualTo(m.col("y"), m.lit(2000))), on="d") \
            .join(sess.from_arrow(stores).filter(
                m.EqualTo(m.col("st"), m.lit("TN"))), on="s") \
            .select(s=m.col("s"), p2=m.Add(m.col("p"), m.col("p"))) \
            .group_by("s").agg(t=m.Sum(m.col("p2")))
        trees.append(q.explain())
    plain, ansi = trees
    assert "TpuFusedStageExec" in plain and "PartialAgg[" in plain, plain
    assert plain.count("ansi=False") == 2, plain
    assert ansi == plain.replace("ansi=False", "ansi=True")


def test_ansi_string_cast_refused_at_plan_time():
    """STRING -> TIMESTAMP and DECIMAL -> STRING, refused until slice 16,
    run on the host engine with the JAX tag under both confs: a string
    that is no timestamp is null, and under ANSI raises; a decimal writes
    its plain digits (tests/test_torch_timestamp_casts.py)."""
    t = pa.table({"s": pa.array(["2001-03-11", "x"]), "k": L(1, 2)})
    for conf in (ANSI, BASE):
        sess = TpuSession(conf, device="cpu")
        ts = sess.from_arrow(t).select(x=PE.Cast(PE.col("s"), T.TIMESTAMP))
        text = sess.from_arrow(t).select(x=PE.Cast(PE.Cast(
            PE.col("k"), T.DecimalType(7, 0)), T.STRING))
        assert "CpuProjectExec" in ts.explain()
        assert text.collect().column("x").to_pylist() == ["1", "2"]
        if conf is ANSI:
            with pytest.raises(AnsiViolation, match="CAST_INVALID_INPUT"):
                ts.collect()
        else:
            assert ts.collect().column("x").cast(pa.int64()).to_pylist() \
                == [984268800000000, None]


def test_ansi_date_cast_refused_as_in_jax():
    """JAX `_tag_cast`: under ANSI only numeric and decimal casts run on
    the device; a date or timestamp cast is refused there and runs on the
    host engine (its explain line says why), with the value it has
    without ANSI, as in the JAX engine's CPU engine."""
    t = pa.table({"k": L(1, 2)})
    q = lambda s, m, tp: s.from_arrow(t).select(  # noqa: E731
        x=m.Cast(m.col("k"), tp.TIMESTAMP))
    conf = dict(ANSI, **{"spark.rapids.sql.explain": "ALL"})
    sess = TpuSession(conf, device="cpu")
    sess.plan_device(q(sess, PE, T).plan)
    assert sess._last_explain.splitlines()[0] == (
        "! CpuProjectExec <- ANSI-mode cast long -> timestamp is not "
        "supported on TPU yet")
    got = q(sess, PE, T).collect()
    assert got.equals(q(TpuSession(BASE, device="cpu"), PE, T).collect())
    want = q(JaxSession(ANSI), JE, JT).collect_cpu()
    assert got.column("x").cast(pa.int64()).to_pylist() == \
        want.column("x").cast(pa.int64()).to_pylist() == [10 ** 6, 2 * 10 ** 6]


@pytest.mark.parametrize("key", ["spark.sql.ansi.enabled",
                                 "spark.rapids.sql.ansi.enabled"])
def test_either_key_turns_ansi_on_per_session(key):
    t = pa.table({"a": L(2 ** 62)})
    q = lambda conf: TpuSession(dict(BASE, **conf), device="cpu") \
        .from_arrow(t).select(x=PE.Add(PE.col("a"), PE.col("a"))).collect()
    with pytest.raises(AnsiViolation, match="long overflow"):
        q({key: True})
    assert q({}).column("x").to_pylist() == [-2 ** 63]


def test_flag_reads_are_counted_once_a_batch():
    """A project and a filter over 3 batches read their flags once a batch
    each; a plan with no ANSI check reads none."""
    t = pa.table({"a": L(*range(12))})
    sess = TpuSession(dict(ANSI, **{"spark.rapids.sql.batchSizeRows": 4}),
                      device="cpu")
    df = sess.from_arrow(t)
    exec_base.COUNTERS.reset()
    df.filter(PE.col("a") > PE.lit(1)).collect()
    assert exec_base.COUNTERS.snapshot() == {"flag_reads": 0}
    df.select(x=PE.col("a") + PE.lit(1)).filter(
        PE.Multiply(PE.col("x"), PE.lit(3)) > PE.lit(1)).collect()
    assert exec_base.COUNTERS.snapshot() == {"flag_reads": 6}
