"""Plan rewrite: plan nodes -> device execs, with per-node fallback to the
host engine (`spark_rapids_tpu/plan/overrides.py`; reference
GpuOverrides wrap/tag/convert, `:3633`, `:4036`, `:4363`).

Two phases, as in the JAX package (`_tag_tree` -> `_convert_tagged`):

  * tag: a meta tree (plan/meta.py) mirrors the plan, and each node and
    expression is held against its rule: the rule's TypeSig for its output
    types, its `spark.rapids.sql.exec.*` / `spark.rapids.sql.expression.*`
    key, and the cast rule (`_tag_cast`, with its ANSI part). A tag is a
    reason the node will not run on the device; `explain` prints it after
    a `!`, in the JAX wording.
  * convert: a node without reasons becomes its device exec (the JAX
    `_c_*` rules, the broadcast choice by estimated build size, the top-k
    rewrite); a tagged node stays a host plan node, run by the port's own
    execs on the CPU (cpu/hostbatch.py), with `TpuFromCpuExec` and
    `CpuFromTpuExec` (exec/transitions.py) at each boundary.

Between the two, with `spark.rapids.sql.optimizer.enabled`, the cost-based
optimizer (plan/cbo.py) may keep device-capable nodes on the host; the
broadcast choice reads its row estimates. After conversion, scan pushdown
(plan/scan_pushdown.py) folds filters, projections and global aggregates
into the parquet scans of every device subtree; then, only when the root
is a device exec, the distribution pass (exec/requirements.py) and fusion
(plan/fusion.py, which walks into both bridges) rewrite the device plan,
in the JAX order.

What the JAX engine runs but no exec of the port computes, on either
device, is not a tag: it raises NotImplementedError while the tree is
tagged (`_check_node`), before any data moves. The port never computes
something else in silence, and nothing moves to the host because CUDA is
absent or a kernel failed.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Type

import torch

from .. import types as T
from ..columnar.column import check_supported
from ..config import UNPORTED_SWITCHES, TpuConf, register
from ..expr import arithmetic as A
from ..expr import cast as CA
from ..expr import conditional as C
from ..expr import nullexprs as NE
from ..expr import predicates as P
from ..expr import aggregates as AG
from ..expr import bitwise as BW
from ..expr import datetime_ as DT
from ..expr import math_ as MA
from ..expr import regex as RX
from ..expr import strings as ES
from ..expr import strings_ext as ESX
from ..expr import strings_more as ESM
from ..expr.decimal128 import is_dec128
from ..expr.base import Alias, AttributeReference, BoundReference, \
    Expression, Literal
from ..expr.hashing import INT_FAMILY, LONG_FAMILY
from ..expr import windowexprs as WX
from ..io.parquet import CpuParquetScanExec
from ..io.scanbase import CpuFileScanExec, TpuFileScanExec
from . import nodes as N
from .cbo import estimate_pass, estimated_bytes, optimize
from .meta import ExprMeta, PlanMeta
from .typesig import TypeSig

__all__ = ["Overrides", "lookup_expr_rule"]

_SUPPORTED_EXPRS = (Literal, BoundReference, AttributeReference, Alias,
                    A.Add, A.Subtract, A.Multiply, A.Divide,
                    A.IntegralDivide, A.Remainder, A.Pmod, A.UnaryMinus,
                    A.Abs, CA.Cast, P.EqualTo, P.LessThan,
                    P.LessThanOrEqual, P.GreaterThan, P.GreaterThanOrEqual,
                    P.And, P.Or, P.Not, P.In, NE.IsNull, NE.IsNotNull,
                    NE.IsNaN, NE.Coalesce, C.If, C.CaseWhen, C.Least,
                    C.Greatest, ES.Length, ES.Upper, ES.Lower, ES.Substring,
                    ES.Concat, ES.StartsWith, ES.EndsWith, ES.Contains,
                    ES.StringTrim, ES.StringTrimLeft, ES.StringTrimRight,
                    RX.RLike, RX.Like, RX.RegExpReplace, RX.RegExpExtract,
                    ESX.StringRepeat, ESX.StringLPad, ESX.StringRPad,
                    ESX.StringLocate, ESX.StringInstr, ESX.StringReplace,
                    ESX.StringTranslate, ESX.StringReverse, ESX.ConcatWs,
                    ESX.SubstringIndex, ESX.InitCap, ESX.Ascii, ESX.Chr,
                    ESX.Left, ESX.Right, ESX.StringSpace, ESX.BitLength,
                    ESX.OctetLength, ESX.FindInSet, ESM.Overlay,
                    ESM.Levenshtein, ESM.SoundEx, ESM.Empty2Null,
                    ESM.FormatNumber, ESM.Conv, MA.UnaryMath, MA.Pow,
                    MA.Atan2, MA.Hypot, MA.Logarithm, MA.Floor, MA.Ceil,
                    MA.Round, MA.BRound, BW.BitwiseAnd, BW.BitwiseOr,
                    BW.BitwiseXor, BW.BitwiseNot, BW.ShiftLeft,
                    BW.ShiftRight, BW.ShiftRightUnsigned) + tuple(
    getattr(DT, _n) for _n in DT.__all__
    if isinstance(getattr(DT, _n), type))
_ARITH_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                T.FloatType, T.DoubleType, T.DecimalType)
_COMPARISONS = (P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                P.GreaterThanOrEqual)
# join types whose build (right) side may be broadcast: no output depends
# on the build side's matched flags being global (right and full would
# emit unmatched build rows once per consumer), so those stay shuffled
_BROADCASTABLE = ("inner", "cross", "left", "semi", "anti", "existence")


def _unsupported(what: str):
    raise NotImplementedError(f"{what} is not supported by "
                              "spark_rapids_tpu_torch yet")


def _value_children(node: Expression):
    """The children whose values a node compares or merges: both sides of
    a comparison, every argument of Coalesce/Least/Greatest, the branches
    (not the predicates) of If and CaseWhen."""
    ch = node.children
    if isinstance(node, C.If):
        return ch[1:]
    if isinstance(node, C.CaseWhen):
        return ch[1::2] + [ch[-1]]
    if isinstance(node, (P.EqualTo, P.LessThan, P.LessThanOrEqual,
                         P.GreaterThan, P.GreaterThanOrEqual, NE.Coalesce,
                         C.Least, C.Greatest)):
        return ch
    return []


def _check_expr(e: Expression) -> None:
    for node in e.collect(lambda _: True):
        if not isinstance(node, _SUPPORTED_EXPRS):
            _unsupported(f"expression {type(node).__name__}")
        if isinstance(node, (A.BinaryArithmetic, A.Divide, A.IntegralDivide,
                             A.UnaryMinus, A.Abs)):
            _check_arithmetic(node)
        check_supported(node.data_type, f"{type(node).__name__} result")
        if isinstance(node, CA.Cast):
            src = node.children[0].data_type
            if not CA.host_supported(src, node.to):
                _unsupported(f"cast from {src.simple_string()} to "
                             f"{node.to.simple_string()}")
        if isinstance(node, ESM.FormatNumber) and \
                isinstance(node.children[0].data_type, T.DecimalType):
            # the JAX kernel formats a decimal's unscaled value
            _unsupported("format_number over "
                         + node.children[0].data_type.simple_string())
        decimals = [c.data_type for c in _value_children(node)
                    if not isinstance(c.data_type, T.NullType)]
        if any(isinstance(t, T.DecimalType) for t in decimals):
            if isinstance(node, _COMPARISONS):
                if not all(isinstance(t, T.DecimalType) for t in decimals):
                    _unsupported("a decimal compared with another type "
                                 "without a cast")
            elif len(set(decimals)) > 1:
                _unsupported(f"{type(node).__name__} over "
                             + ", ".join(t.simple_string() for t in decimals)
                             + " without a cast")
        strings = [isinstance(c.data_type, T.StringType)
                   for c in _value_children(node)]
        if any(strings) and not all(strings):
            _unsupported(f"{type(node).__name__} over a string and another "
                         "type")
        if any(strings) and isinstance(node, (C.Least, C.Greatest)):
            _unsupported(f"{type(node).__name__} over strings")
        if isinstance(node, (C.Least, C.Greatest)) and \
                any(is_dec128(c.data_type) for c in node.children):
            _unsupported(f"{type(node).__name__} over a decimal of more "
                         "than 18 digits")
        _check_argument_types(node)
        if isinstance(node, P.In):
            if is_dec128(node.children[0].data_type):
                # the JAX In broadcasts one value a row against the limbs
                _unsupported("In over a decimal of more than 18 digits")
            _check_in_items(node)


_DATE = (T.DateType,)
_DATE_TS = (T.DateType, T.TimestampType)
_TS = (T.TimestampType,)
_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)
_PLAIN_NUM = _INTEGRAL + (T.FloatType, T.DoubleType)
# the operand types each datetime, math and bitwise class computes. The
# JAX classes read a DATE's day count, a TIMESTAMP's microseconds or a
# number as it is, with no analyzer to cast them, so another type (a
# decimal's unscaled value, a timestamp read as days) would be another
# value: the port refuses it (ROADMAP.md "Port-only refusals")
_ARG_TYPES = (
    (DT.DateAdd, (_DATE, _INTEGRAL)), (DT.AddMonths, (_DATE, _INTEGRAL)),
    (DT.DateDiff, (_DATE, _DATE)), (DT.MonthsBetween, (_DATE_TS, _DATE_TS)),
    (DT.MakeDate, (_INTEGRAL,) * 3), (DT.Hour, (_TS,)), (DT.Minute, (_TS,)),
    (DT.Second, (_TS,)), (DT.UnixTimestampFromTs, (_TS,)),
    (DT.TruncTimestamp, (_TS,)), (DT.DateFormat, (_DATE_TS,)),
    (DT.FromUnixTime, (_INTEGRAL,)), (DT.ToUnixTimestamp, ((T.StringType,),)),
    (DT.TimestampSeconds, (_INTEGRAL,)), (DT.TimestampMillis, (_INTEGRAL,)),
    (DT.TimestampMicros, (_INTEGRAL,)), (DT.DateFromUnixDate, (_INTEGRAL,)),
    (DT.Year, (_DATE_TS,)), (DT.Month, (_DATE_TS,)),
    (DT.DayOfMonth, (_DATE_TS,)), (DT.Quarter, (_DATE_TS,)),
    (DT.DayOfWeek, (_DATE_TS,)), (DT.WeekDay, (_DATE_TS,)),
    (DT.DayOfYear, (_DATE_TS,)), (DT.WeekOfYear, (_DATE_TS,)),
    (DT.LastDay, (_DATE,)), (DT.TruncDate, (_DATE,)), (DT.NextDay, (_DATE,)),
    (DT.DayName, (_DATE,)), (DT.MonthName, (_DATE,)), (DT.UnixDate, (_DATE,)),
    (MA.UnaryMath, (_PLAIN_NUM,)), (MA.Pow, (_PLAIN_NUM,) * 2),
    (MA.Atan2, (_PLAIN_NUM,) * 2), (MA.Hypot, (_PLAIN_NUM,) * 2),
    (MA.Logarithm, (_PLAIN_NUM,) * 2), (MA.Floor, (_PLAIN_NUM,)),
    (MA.Ceil, (_PLAIN_NUM,)), (MA.Round, (_PLAIN_NUM,)),
    (MA.BRound, (_PLAIN_NUM,)), (BW.BitwiseAnd, (_INTEGRAL,) * 2),
    (BW.BitwiseOr, (_INTEGRAL,) * 2), (BW.BitwiseXor, (_INTEGRAL,) * 2),
    (BW.BitwiseNot, (_INTEGRAL,)), (BW.ShiftLeft, (_INTEGRAL,) * 2),
    (BW.ShiftRight, (_INTEGRAL,) * 2),
    (BW.ShiftRightUnsigned, (_INTEGRAL,) * 2))


def _check_argument_types(node: Expression) -> None:
    for cls, kinds in _ARG_TYPES:
        if isinstance(node, cls):
            types = [c.data_type for c in node.children]
            if not all(isinstance(t, k) for t, k in zip(types, kinds)):
                _unsupported(f"{type(node).__name__} over " + ", ".join(
                    t.simple_string() for t in types))
            return


def _check_in_items(node: "P.In") -> None:
    """IN's items are literals of the value's kind: strings for a string
    value, numbers otherwise (a decimal value's as Decimal or int)."""
    import decimal
    vt = node.children[0].data_type
    for item in node.items:
        if item is None:
            continue
        if isinstance(vt, T.StringType):
            ok = isinstance(item, str)
        elif isinstance(vt, T.DecimalType):
            ok = isinstance(item, (int, decimal.Decimal)) and \
                not isinstance(item, bool)
        elif isinstance(vt, T.BooleanType):
            ok = isinstance(item, bool)
        else:
            ok = isinstance(item, (int, float)) and \
                not isinstance(item, bool)
        if not ok:
            _unsupported(f"In over {vt.simple_string()} with the item "
                         f"{item!r}")


def _check_arithmetic(node: Expression) -> None:
    """Numeric operands, before the node's type is read (numeric_promote
    has no answer for others). Decimal Multiply, Remainder and Pmod, and a
    decimal mixed with another type in +/-, raise from the node's type (the
    JAX package has neither decimal Multiply nor Spark's decimal
    promotion); IntegralDivide has a LONG type, so its decimal operands are
    refused here, as is Divide over a decimal of more than 18 digits (the
    JAX Divide reads one int64 a row)."""
    types = [c.data_type for c in node.children]
    if not all(isinstance(t, _ARITH_TYPES) for t in types) or (
            isinstance(node, A.IntegralDivide)
            and any(isinstance(t, T.DecimalType) for t in types)) or (
            isinstance(node, A.Divide) and any(map(is_dec128, types))):
        _unsupported(f"{type(node).__name__} over " + ", ".join(
            t.simple_string() for t in types))


# ----------------------------------------------------------------------------
# Rules (JAX `expr_rule`/`exec_rule`, plan/overrides.py:48-54, :632-643):
# a TypeSig for the node's output, the auto-registered enable key, and, for
# an exec, the convert function and the expressions its meta tags. Only the
# rules of nodes the port has are registered.
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class ExprRule:
    cls: Type
    sig: TypeSig
    conf_key: str
    incompat: bool = False
    tag_fn: Optional[Callable[[ExprMeta], None]] = None
    doc: str = ""


@dataclasses.dataclass
class ExecRule:
    cls: Type
    sig: TypeSig
    conf_key: str
    convert_fn: Callable
    expr_fn: Optional[Callable[[PlanMeta], None]] = None


_EXPR_RULES: Dict[Type, ExprRule] = {}
_EXEC_RULES: Dict[Type, ExecRule] = {}


def expr_rule(cls: Type, sig: TypeSig, incompat: bool = False,
              tag_fn=None, doc: str = "") -> None:
    key = f"spark.rapids.sql.expression.{cls.__name__}"
    register(key, "bool", True,
             f"Enable device execution of expression {cls.__name__}.")
    _EXPR_RULES[cls] = ExprRule(cls, sig, key, incompat, tag_fn, doc)


def exec_rule(cls: Type, sig: TypeSig, convert_fn, expr_fn=None) -> None:
    key = f"spark.rapids.sql.exec.{cls.__name__.replace('Cpu', 'Tpu')}"
    register(key, "bool", True,
             f"Enable device execution of {cls.__name__}.")
    _EXEC_RULES[cls] = ExecRule(cls, sig, key, convert_fn, expr_fn)


def lookup_expr_rule(expr: Expression, conf: TpuConf) -> ExprMeta:
    return ExprMeta(expr, conf, _EXPR_RULES.get(type(expr)))


def _tag_cast(meta: ExprMeta) -> None:
    """JAX `_tag_cast`: a cast the device rule refuses, and under ANSI any
    cast but numeric <-> numeric and those from or to a decimal, runs on
    the host (expr/cast.py computes both sides)."""
    e = meta.expr
    src = e.children[0].data_type
    if not CA.device_supported(src, e.to):
        meta.will_not_work(
            f"cast {src.simple_string()} -> {e.to.simple_string()} is not "
            "supported on TPU")
    if meta.conf.is_ansi and not CA.ansi_supported(src, e.to):
        meta.will_not_work(
            f"ANSI-mode cast {src.simple_string()} -> "
            f"{e.to.simple_string()} is not supported on TPU yet")


_basic = TypeSig.all_basic()
_basic38 = TypeSig.all_basic(decimal_max=38)
_nested38 = TypeSig.all_with_nested(decimal_max=38)
_num = TypeSig.numeric()
_num38 = TypeSig.numeric(decimal_max=38)
_bool = TypeSig((T.BooleanType,))
_dbl = TypeSig((T.DoubleType,))

for _c in (Literal, AttributeReference, BoundReference, Alias):
    expr_rule(_c, _nested38)
for _c in (A.Add, A.Subtract, A.UnaryMinus, A.Abs):
    expr_rule(_c, _num38)
for _c in (A.Multiply, A.Divide, A.IntegralDivide, A.Remainder, A.Pmod):
    expr_rule(_c, _num)
for _c in (P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
           P.GreaterThanOrEqual, P.And, P.Or, P.Not, P.In, NE.IsNull,
           NE.IsNotNull, NE.IsNaN, AG.BoolAnd, AG.BoolOr):
    expr_rule(_c, _bool)
for _c in (NE.Coalesce, C.If, C.CaseWhen, AG.Sum, AG.Count, AG.Min, AG.Max,
           AG.Average, AG.First, AG.Last):
    expr_rule(_c, _basic38)
for _c in (C.Least, C.Greatest, WX.RowNumber, WX.Rank, WX.DenseRank,
           WX.PercentRank, WX.CumeDist, WX.NTile):
    expr_rule(_c, _basic)
# the port's window gathers limbs (the JAX rules stop at 18 digits; its
# limb refusals are _check_window_agg's)
for _c in (WX.Lead, WX.Lag, WX.WindowAggregate, WX.NthValue):
    expr_rule(_c, _basic38)
expr_rule(CA.Cast, _basic38, tag_fn=_tag_cast)
# moment forms can differ from the JVM's streaming updates in low ULPs
for _c in (AG.VariancePop, AG.VarianceSamp, AG.StddevPop, AG.StddevSamp,
           AG.Skewness, AG.Kurtosis):
    expr_rule(_c, _dbl, incompat=True)
expr_rule(AG.CountIf, TypeSig((T.LongType,)))
for _c in (AG.BitAndAgg, AG.BitOrAgg, AG.BitXorAgg):
    expr_rule(_c, TypeSig.integral())
_str = TypeSig((T.StringType,))
expr_rule(ES.Length, TypeSig((T.IntegerType,)))
for _c in (ES.Upper, ES.Lower):
    expr_rule(_c, _str, incompat=True,
              doc="ASCII-only case mapping on device (non-ASCII passes "
                  "through unchanged); reference notes similar locale "
                  "corner cases.")
for _c in (ES.Substring, ES.Concat, ES.StringTrim, ES.StringTrimLeft,
           ES.StringTrimRight):
    expr_rule(_c, _str)
for _c in (ES.StartsWith, ES.EndsWith, ES.Contains):
    expr_rule(_c, _bool)


def _tag_regex(meta: ExprMeta) -> None:
    """JAX `_tag_regex`: the user's switch, then the pattern's compile."""
    e = meta.expr
    if not meta.conf.get("spark.rapids.sql.regexp.enabled"):
        meta.will_not_work("regular expressions are disabled via "
                           "spark.rapids.sql.regexp.enabled")
        return
    if e.device_reason is not None:
        meta.will_not_work(
            f"{e.name} pattern is not supported on TPU: {e.device_reason}")


def _tag_regex_cpu_only(meta: ExprMeta) -> None:
    meta.will_not_work(
        f"{meta.expr.name} runs on CPU (device byte-rewrite kernel pending)")


for _c in (RX.RLike, RX.Like):
    expr_rule(_c, _bool, incompat=True, tag_fn=_tag_regex,
              doc="Byte-level regex machine: exact for ASCII subjects; "
                  "counted quantifiers over multi-byte UTF-8 characters "
                  "can differ from the JVM (reference marks regexp "
                  "incompat similarly).")
for _c in (RX.RegExpReplace, RX.RegExpExtract):
    expr_rule(_c, _str, tag_fn=_tag_regex_cpu_only)


def _tag_device_reason(meta: ExprMeta) -> None:
    """The JAX literal and ASCII tags of strings_ext (`_lit_tag`,
    `_tag_pad`, `_tag_translate`, `_tag_replace`,
    `_tag_substring_index`): a non-literal size, pad, separator or
    pattern, or a non-ASCII pad or translate argument, runs on the host,
    where the expression computes Spark's rule row by row."""
    reason = meta.expr.device_reason()
    if reason is not None:
        meta.will_not_work(reason)


_int = TypeSig((T.IntegerType,))
for _c in (ESX.StringRepeat, ESX.StringLPad, ESX.StringRPad,
           ESX.StringReplace, ESX.StringTranslate, ESX.ConcatWs,
           ESX.SubstringIndex, ESX.StringSpace):
    expr_rule(_c, _str, tag_fn=_tag_device_reason)
for _c in (ESX.StringLocate, ESX.StringInstr, ESX.Ascii, ESX.BitLength,
           ESX.OctetLength, ESX.FindInSet, ESM.Levenshtein):
    expr_rule(_c, _int)
for _c in (ESX.StringReverse, ESX.Chr, ESX.Left, ESX.Right, ESM.Overlay,
           ESM.SoundEx, ESM.Empty2Null, ESM.Conv):
    expr_rule(_c, _str)
expr_rule(ESX.InitCap, _str, incompat=True,
          doc="ASCII-only case mapping on device, like Upper/Lower.")
expr_rule(ESM.FormatNumber, _str,
          doc="Enable format_number; |values| at int64 scale or beyond "
              "return null (19+ digit JVM DecimalFormat not reproduced).")

# math, bitwise and datetime (JAX plan/overrides.py:123-131, :147-150,
# :343-353, :440-455): the transcendentals may differ from the JVM in ULPs
for _c in (MA.Sqrt, MA.Exp, MA.Log, MA.Log10, MA.Log2, MA.Pow, MA.Signum,
           MA.Sin, MA.Cos, MA.Tan, MA.Asin, MA.Acos, MA.Atan, MA.Sinh,
           MA.Cosh, MA.Tanh, MA.Cbrt, MA.ToDegrees, MA.ToRadians, MA.Atan2,
           MA.Hypot, MA.Logarithm, MA.Expm1, MA.Log1p, MA.Rint, MA.Cot):
    expr_rule(_c, _dbl, incompat=True,
              doc="Transcendental results may differ from the JVM in ULPs.")
for _c in (MA.Floor, MA.Ceil, MA.Round, MA.BRound):
    expr_rule(_c, _num)
for _c in (BW.BitwiseAnd, BW.BitwiseOr, BW.BitwiseXor, BW.BitwiseNot,
           BW.ShiftLeft, BW.ShiftRight, BW.ShiftRightUnsigned):
    expr_rule(_c, TypeSig.integral())
_date = TypeSig((T.DateType,))
_ts = TypeSig((T.TimestampType,))
_long = TypeSig((T.LongType,))
for _c in (DT.Year, DT.Month, DT.DayOfMonth, DT.Quarter, DT.DayOfWeek,
           DT.WeekDay, DT.DayOfYear, DT.Hour, DT.Minute, DT.Second,
           DT.DateDiff, DT.WeekOfYear, DT.UnixDate):
    expr_rule(_c, _int)
for _c in (DT.DateAdd, DT.DateSub, DT.LastDay, DT.AddMonths, DT.TruncDate,
           DT.NextDay, DT.DateFromUnixDate, DT.MakeDate):
    expr_rule(_c, _date)
for _c in (DT.TimestampSeconds, DT.TimestampMillis, DT.TimestampMicros,
           DT.TruncTimestamp):
    expr_rule(_c, _ts)
for _c in (DT.UnixTimestampFromTs, DT.ToUnixTimestamp, DT.UnixTimestamp):
    expr_rule(_c, _long)
expr_rule(DT.MonthsBetween, _dbl)
for _c in (DT.DayName, DT.MonthName, DT.FromUnixTime):
    expr_rule(_c, _str)
expr_rule(DT.DateFormat, _str,
          doc="Enable date_format (fixed-width yyyy/MM/dd/HH/mm/ss "
              "patterns; UTC).")


def _exprs_project(m: PlanMeta):
    for e in m.plan._bound:
        m.add_expr(e)


def _exprs_filter(m: PlanMeta):
    m.add_expr(m.plan._bound)


def _exprs_agg(m: PlanMeta):
    for e in m.plan._bound_groups:
        m.add_expr(e)
    for a in m.plan._bound_aggs:
        m.add_expr(a.func)


def _exprs_join(m: PlanMeta):
    for e in m.plan._bl + m.plan._br:
        m.add_expr(e)
    if m.plan._bcond is not None:
        m.add_expr(m.plan._bcond)


def _exprs_sort(m: PlanMeta):
    for e, _, _ in m.plan._bound:
        m.add_expr(e)


def _exprs_window(m: PlanMeta):
    for e in m.plan._bound_part:
        m.add_expr(e)
    for e, _, _ in m.plan._bound_order:
        m.add_expr(e)
    for f, _ in m.plan._bound_fns:
        m.add_expr(f)


def _exprs_expand(m: PlanMeta):
    for p in m.plan._bound:
        for e in p:
            m.add_expr(e)


def _c_scan(ov, plan, children):
    from ..exec.basic import TpuScanExec
    return TpuScanExec(plan.table, ov.device, ov.conf)


def _c_file_scan(ov, plan, children):
    return TpuFileScanExec(plan, ov.conf, ov.device)


def _c_project(ov, plan, children):
    from ..exec.basic import TpuProjectExec
    return TpuProjectExec(plan.exprs, children[0], ov.conf)


def _c_filter(ov, plan, children):
    from ..exec.basic import TpuFilterExec
    return TpuFilterExec(plan.condition, children[0], ov.conf)


def _c_agg(ov, plan, children):
    from ..exec.aggregate import TpuHashAggregateExec
    return TpuHashAggregateExec(plan.group_exprs, plan.aggs, children[0],
                                ov.conf)


def _c_join(ov, plan, children):
    """JAX `_c_join`: a keyless join is the nested-loop exec (its build
    broadcast when small), a small build of a broadcastable type a
    broadcast hash join, the rest (right and full always) a shuffled hash
    join."""
    from ..exec.broadcast import TpuBroadcastExchangeExec
    from ..exec.joins import (TpuBroadcastHashJoinExec,
                              TpuNestedLoopJoinExec,
                              TpuShuffledHashJoinExec)
    conf = ov.conf
    threshold = conf.get("spark.rapids.sql.autoBroadcastJoinThreshold")
    small_build = (threshold >= 0 and plan.join_type in _BROADCASTABLE
                   and estimated_bytes(plan.children[1]) <= threshold)
    if not plan.left_keys:
        build = TpuBroadcastExchangeExec(children[1], conf) \
            if small_build else children[1]
        return TpuNestedLoopJoinExec(children[0], build, plan.condition,
                                     plan.join_type, conf)
    if small_build:
        join = TpuBroadcastHashJoinExec(
            children[0], TpuBroadcastExchangeExec(children[1], conf),
            plan.left_keys, plan.right_keys, plan.join_type, conf,
            condition=plan.condition)
        _wire_dynamic_pruning(join, plan, conf)
        return join
    return TpuShuffledHashJoinExec(children[0], children[1], plan.left_keys,
                                   plan.right_keys, plan.join_type, conf,
                                   condition=plan.condition)


def _c_sort(ov, plan, children):
    from ..exec.sort import TpuSortExec
    return TpuSortExec(plan.orders, children[0], ov.conf)


def _c_limit(ov, plan, children):
    """LIMIT over ORDER BY becomes a top-k (TakeOrderedAndProjectExec
    analog, GpuOverrides.scala:3705): a per-batch k-select and a running
    merge replace the full sort, when spark.rapids.sql.topK.enabled and
    limit + offset <= spark.rapids.sql.topK.threshold."""
    from ..exec.basic import TpuLimitExec
    from ..exec.sort import TpuSortExec, TpuTopKExec
    conf, child = ov.conf, children[0]
    if conf.get("spark.rapids.sql.topK.enabled") and \
            isinstance(child, TpuSortExec) and not child.each_batch and \
            plan.limit + plan.offset <= \
            conf.get("spark.rapids.sql.topK.threshold"):
        return TpuTopKExec(child.orders, plan.limit, child.child, conf,
                           plan.offset)
    return TpuLimitExec(plan.limit, child, plan.offset, conf)


def _c_union(ov, plan, children):
    from ..exec.basic import TpuUnionExec
    return TpuUnionExec(children, ov.conf)


def _c_range(ov, plan, children):
    from ..exec.basic import TpuRangeExec
    return TpuRangeExec(plan.start, plan.end, plan.step, ov.device, ov.conf)


def _c_sample(ov, plan, children):
    from ..exec.basic import TpuSampleExec
    return TpuSampleExec(plan.fraction, plan.seed, children[0], ov.conf)


def _c_expand(ov, plan, children):
    from ..exec.basic import TpuExpandExec
    return TpuExpandExec(plan.projections, plan.names, children[0], ov.conf)


def _c_window(ov, plan, children):
    from ..exec.window import TpuWindowExec
    return TpuWindowExec(plan.window_exprs, plan.partition_spec,
                         plan.order_spec, children[0], ov.conf)


# the join, file scan and window rules take decimals to 38 digits, the
# precision their execs compute on the device, where the JAX rules stop at
# 18 (ROADMAP.md "Known differences")
exec_rule(N.CpuScanExec, _nested38, _c_scan)
exec_rule(CpuParquetScanExec, _basic38, _c_file_scan)
exec_rule(N.CpuProjectExec, _nested38, _c_project, _exprs_project)
exec_rule(N.CpuFilterExec, _nested38, _c_filter, _exprs_filter)
exec_rule(N.CpuHashAggregateExec, _nested38, _c_agg, _exprs_agg)
exec_rule(N.CpuHashJoinExec, _nested38, _c_join, _exprs_join)
exec_rule(N.CpuSortExec, TypeSig.orderable(decimal_max=38), _c_sort,
          _exprs_sort)
exec_rule(N.CpuLimitExec, _nested38, _c_limit)
exec_rule(N.CpuSampleExec, _nested38, _c_sample)
exec_rule(N.CpuUnionExec, _nested38, _c_union)
exec_rule(N.CpuRangeExec, _basic, _c_range)
exec_rule(N.CpuExpandExec, _basic, _c_expand, _exprs_expand)
exec_rule(N.CpuWindowExec, _basic38, _c_window, _exprs_window)


class Overrides:
    """Entry point (reference GpuOverrides.apply): refuse what the port
    cannot run anywhere, tag, convert with transitions, then distribute
    over the mesh and fuse a device-rooted plan."""

    def __init__(self, conf: TpuConf, device: torch.device):
        self.conf = conf
        self.device = torch.device(device)
        self.explain_log: List[str] = []

    def apply(self, plan: N.PhysicalPlan):
        """A device exec (the whole plan, or a device root over host
        subtrees) or a host plan whose device subtrees are bridged back."""
        from ..exec.base import TpuExec
        if not self.conf.is_sql_enabled:
            return plan
        for key, what in _UNPORTED_KEYS:
            v = self.conf.get(key)
            if (v.strip() if isinstance(v, str) else v):
                _unsupported(f"{key}={v} ({what})")
        meta = self._tag_tree(plan)
        # one memo of row estimates spans the optimizer and the convert
        # walk's broadcast choices
        with estimate_pass():
            if self.conf.get("spark.rapids.sql.optimizer.enabled"):
                optimize(meta, self.conf)
            result = self._convert_tagged(plan, meta)
        explain = self.conf.explain
        if explain != "NONE":
            lines = meta.explain_lines()
            if explain == "ALL" or any(ln.lstrip().startswith("!")
                                       for ln in lines):
                self.explain_log.extend(lines)
        if self.conf.get("spark.rapids.sql.mode") == "explainOnly":
            return plan
        # scan pushdown folds filter/project/aggregate chains into the file
        # scans under them, on every device subtree (off: one conf read)
        from .scan_pushdown import apply_scan_pushdown
        result = apply_scan_pushdown(result, self.conf)
        if isinstance(result, TpuExec):
            # the distribution pass first (partial -> key-exchange ->
            # final, zipped joins), then fusion, which takes the partial
            # aggregate as its stage-terminal member; under a host root
            # neither runs, as in the JAX package
            from ..exec.requirements import ensure_distribution
            result = ensure_distribution(result, self.conf)
            from .fusion import apply_fusion
            result = apply_fusion(result, self.conf)
        return result

    def explain_string(self) -> str:
        return "\n".join(self.explain_log)

    def _convert(self, plan: N.PhysicalPlan):
        """A plan tagged and converted, without the device passes."""
        return self._convert_tagged(plan, self._tag_tree(plan))

    def _tag_tree(self, plan: N.PhysicalPlan) -> PlanMeta:
        """Phase 1: the meta tree, every node tagged before any converts.
        A port-only refusal raises here, before any data moves."""
        rule = _EXEC_RULES.get(type(plan))
        meta = PlanMeta(plan, self.conf, rule)
        for c in plan.children:
            meta.child_metas.append(self._tag_tree(c))
        _check_node(plan)
        if rule is not None and rule.expr_fn is not None:
            rule.expr_fn(meta)
        meta.tag_for_device()
        if self.conf.is_test_enabled and not meta.can_run_on_device:
            raise AssertionError(
                "spark.rapids.sql.test.enabled: plan node fell back to CPU: "
                + "; ".join(meta.reasons))
        return meta

    def _convert_tagged(self, plan: N.PhysicalPlan, meta: PlanMeta):
        """Phase 2: convert by the tags, bridging host <-> device. A host
        node is a copy of the plan node over its converted children (the
        caller's plan stays as it was)."""
        from ..exec.base import TpuExec
        from ..exec.transitions import CpuFromTpuExec, TpuFromCpuExec
        children = [self._convert_tagged(c, cm)
                    for c, cm in zip(plan.children, meta.child_metas)]
        if meta.can_run_on_device:
            children = [c if isinstance(c, TpuExec) else
                        TpuFromCpuExec(c, self.conf, self.device)
                        for c in children]
            return meta.rule.convert_fn(self, plan, children)
        node = copy.copy(plan)
        node.children = [CpuFromTpuExec(c) if isinstance(c, TpuExec) else c
                         for c in children]
        return node


# conf keys of modules the port does not have: each raises at plan time
_UNPORTED_KEYS = (
    ("spark.rapids.tpu.mesh.enabled", "the sharded plan"),
    ("spark.rapids.tpu.sched.enabled", "the query scheduler"),
    ("spark.rapids.tpu.sched.tenant.quotas", "tenant memory sub-quotas"),
    ("spark.rapids.tpu.mesh.hbmPerChip", "per-chip memory ledgers"),
) + UNPORTED_SWITCHES


def _check_node(plan: N.PhysicalPlan) -> None:
    """The port-only refusals of one plan node: what no exec of the port
    computes, on either device, though the JAX engine runs it (ROADMAP.md
    lists each). They raise NotImplementedError; a JAX tag does not."""
    if isinstance(plan, N.CpuScanExec):
        for dt in plan.output.types:
            check_supported(dt, "scan column")
    elif isinstance(plan, CpuFileScanExec):
        if plan.format_name != "parquet":
            _unsupported(f"the {plan.format_name} scan")
        # what the device decode declines is decoded on the host; only
        # nested and binary columns (`schema_from_arrow`) are refused
        for dt in plan.output.types:
            check_supported(dt, "scan column")
    elif isinstance(plan, N.CpuProjectExec):
        for e in plan._bound:
            _check_expr(e)
    elif isinstance(plan, N.CpuFilterExec):
        _check_expr(plan._bound)
        if not isinstance(plan._bound.data_type, T.BooleanType):
            _unsupported("a non-boolean filter condition")
    elif isinstance(plan, N.CpuHashAggregateExec):
        for e in plan._bound_groups:
            _check_expr(e)
        for a in plan._bound_aggs:
            _check_aggregate(a.func)
    elif isinstance(plan, N.CpuHashJoinExec):
        _check_join(plan)
    elif isinstance(plan, N.CpuSortExec):
        _check_orders(plan._bound)
    elif isinstance(plan, N.CpuUnionExec):
        if len({tuple(c.output.types) for c in plan.children}) > 1:
            _unsupported("a union of children with different column types")
    elif isinstance(plan, N.CpuWindowExec):
        _check_window(plan)
    elif isinstance(plan, N.CpuExpandExec):
        _check_expand(plan)
    elif not isinstance(plan, (N.CpuLimitExec, N.CpuSampleExec,
                               N.CpuRangeExec)):
        _unsupported(f"plan node {plan.name}")


def _check_expand(plan: N.CpuExpandExec) -> None:
    """Every projection's expressions are the port's, and each projection
    gives the node's columns at the first one's types (a batch holds one
    type a column: a null in a rollup level is a typed null literal)."""
    types = plan.output.types
    for p in plan._bound:
        if len(p) != len(plan.names):
            _unsupported(f"an Expand projection of {len(p)} columns for "
                         f"{len(plan.names)} names")
        for e, t in zip(p, types):
            _check_expr(e)
            if e.data_type != t:
                _unsupported(f"an Expand column of types "
                             f"{t.simple_string()} and "
                             f"{e.data_type.simple_string()}")


def _check_join(plan: N.CpuHashJoinExec) -> None:
    """JAX `_tag_join`'s cases (which the port's join computes on neither
    device), the key checks of the port's hash join, and its condition."""
    from ..exec.joins import SUPPORTED_JOIN_TYPES
    for e in plan.left_keys + plan.right_keys:
        if not isinstance(e, AttributeReference):
            _unsupported("a join key that is not a column reference "
                         "(join keys must be column references: project "
                         "them first)")
    if plan.join_type not in SUPPORTED_JOIN_TYPES:
        _unsupported(f"join type {plan.join_type}")
    for e in plan._bl + plan._br:
        check_supported(e.data_type, "join key")
        if is_dec128(e.data_type):  # the JAX murmur3 stops at 18 digits
            _unsupported(f"a {e.data_type.simple_string()} join key")
    ints = INT_FAMILY + LONG_FAMILY
    for lk, rk in zip(plan._bl, plan._br):
        # keys hash by their stored values, so both sides must share one
        # type (Spark casts them to one; a decimal also shares its scale
        # and precision); only the int and long families mix, as before
        if lk.data_type != rk.data_type and not (
                isinstance(lk.data_type, ints)
                and isinstance(rk.data_type, ints)
                and T.DecimalType not in (type(lk.data_type),
                                          type(rk.data_type))):
            _unsupported(f"join keys {lk.data_type.simple_string()} and "
                         f"{rk.data_type.simple_string()}")
    if plan._bcond is not None:
        _check_expr(plan._bcond)
        if not isinstance(plan._bcond.data_type, T.BooleanType):
            _unsupported("a non-boolean join condition")


# the aggregates over values of the numeric types only (their moments are
# computed in DOUBLE): the JAX exec reads a decimal's unscaled value there
_DOUBLE_MOMENTS = (AG._VarianceFamily, AG._MomentFamily)
_NUMERIC_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.FloatType, T.DoubleType)
_INTEGRAL_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


def _check_aggregate(func) -> None:
    """A grouped aggregate of the slice over a child of a type it takes:
    every aggregate of the JAX `_agg_one`; CollectList, CollectSet and
    ApproximatePercentile (array results and the single-pass path) and
    CountDistinct (no JAX exec computes it) raise."""
    from ..exec.aggregate import SUPPORTED_AGGREGATES
    name = type(func).__name__
    if func.single_pass or not isinstance(func, SUPPORTED_AGGREGATES):
        _unsupported(f"aggregate {name}")
    if func.child is None:
        return
    ct = func.child.data_type
    what = f"{name.lower()} over {ct.simple_string()}"
    if isinstance(func, (AG.Sum, AG.Average)):
        ok = isinstance(ct, _ARITH_TYPES)
    elif isinstance(func, _DOUBLE_MOMENTS):
        ok = isinstance(ct, _NUMERIC_TYPES)
    elif isinstance(func, (AG.CountIf, AG.BoolAnd, AG.BoolOr)):
        ok = isinstance(ct, T.BooleanType)
    elif isinstance(func, AG._BitAgg):
        ok = isinstance(ct, _INTEGRAL_TYPES)
    else:
        ok = True
    if not ok:
        _unsupported(what)
    for pt in func.partial_types():
        check_supported(pt, f"{what}: its partial buffer")
    _check_expr(func.child)
    check_supported(func.data_type, f"{name} result")


def _check_orders(bound_orders) -> None:
    """Sort keys: expressions of the slice, each of a carried type."""
    for e, _, _ in bound_orders:
        _check_expr(e)
        check_supported(e.data_type, "sort key")


_WINDOW_AGGREGATES = ("Sum", "Count", "Min", "Max", "Average", "First",
                      "Last")


def _check_window(plan: N.CpuWindowExec) -> None:
    """`_tag_window` and `_tag_window_agg` of the JAX package, as errors:
    every function needing an ORDER BY has one; value-offset RANGE frames
    have one order column of a numeric, date or timestamp type; window
    aggregates are Sum, Count, Min, Max, Average, First or Last, with no
    bounded frame over a string MIN/MAX. Beyond the JAX checks, these
    raise: an Average over a decimal, a value-offset RANGE frame over a
    decimal order key, a Sum whose result passes 18 digits (the JAX window
    accumulates it in one 1-D buffer under a 128-bit type, and its result
    fails to convert) and a Min or Max over a decimal of more than 18
    digits (the JAX window's neutral fill does not broadcast over limbs)."""
    for e in plan._bound_part:
        _check_expr(e)
        check_supported(e.data_type, "window partition key")
    _check_orders(plan._bound_order)
    has_order = bool(plan.order_spec)
    for f, name in plan._bound_fns:
        what = f"window column {name}"
        if f.requires_order and not has_order:
            _unsupported(f"{what}: {type(f).__name__} without an ORDER BY "
                         "(window function requires an ORDER BY)")
        frame = getattr(f, "frame", None)
        if isinstance(f, (WX.WindowAggregate, WX.NthValue)) and \
                WX.is_value_range_frame(frame):
            if len(plan.order_spec) != 1:
                _unsupported(f"{what}: a value-offset RANGE frame without "
                             "exactly one order column")
            key_t = plan._bound_order[0][0].data_type
            if not (T.is_numeric(key_t) or
                    isinstance(key_t, (T.DateType, T.TimestampType))) or \
                    isinstance(key_t, T.DecimalType):
                _unsupported(f"{what}: a value-offset RANGE frame over a "
                             f"{key_t.simple_string()} order column")
        for c in f.children:
            _check_expr(c)
        if isinstance(f, WX.WindowAggregate):
            _check_window_agg(f, what)
        check_supported(f.data_type, f"{what} result")


def _check_window_agg(f, what: str) -> None:
    name = type(f.func).__name__
    if name not in _WINDOW_AGGREGATES:
        _unsupported(f"{what}: {name} over a window")
    child = f.func.child
    if child is None:
        return
    ct = child.data_type
    if name in ("Sum", "Average") and not isinstance(ct, _ARITH_TYPES):
        _unsupported(f"{what}: {name.lower()} over {ct.simple_string()}")
    if name == "Average" and isinstance(ct, T.DecimalType):
        _unsupported(f"{what}: a window average over {ct.simple_string()}")
    if name == "Sum" and is_dec128(f.func.data_type):
        _unsupported(f"{what}: a window sum of "
                     f"{f.func.data_type.simple_string()}")
    if name in ("Min", "Max") and is_dec128(ct):
        _unsupported(f"{what}: a window {name} over {ct.simple_string()}")
    frame = f.frame
    bounded = WX.is_value_range_frame(frame) or (
        isinstance(frame, WX.RowFrame) and not (
            frame.lower is None and frame.upper in (0, None)))
    if name in ("Min", "Max") and bounded and isinstance(ct, T.StringType):
        _unsupported(f"{what}: a bounded-frame window {name} over STRING")


# join types in which a probe row without a build match never reaches the
# output, so pruning probe row groups by the build keys cannot change a
# result (left and anti emit unmatched probe rows)
_DPP_SAFE = ("inner", "semi")


def _dpp_scan_for_column(node, colname):
    """Descend column-preserving execs from the probe root to a parquet
    scan that provides `colname` unchanged: (scan, its column) or None."""
    from ..exec.basic import TpuFilterExec, TpuProjectExec
    if isinstance(node, TpuFileScanExec):
        return (node, colname) if (node.cpu_scan.format_name == "parquet"
                                   and colname in node.output.names) \
            else None
    if isinstance(node, TpuFilterExec):
        return _dpp_scan_for_column(node.children[0], colname)
    if isinstance(node, TpuProjectExec):
        for e in node.exprs:
            src = e.children[0] if isinstance(e, Alias) else e
            name = e.alias if isinstance(e, Alias) else \
                getattr(e, "col_name", None)
            if name == colname and isinstance(src, AttributeReference):
                return _dpp_scan_for_column(node.children[0], src.col_name)
    return None


def _wire_dynamic_pruning(join, plan, conf) -> None:
    """Attach DynamicKeyFilters between a broadcast hash join and the probe
    parquet scans its keys are columns of (`plan/overrides.py`
    `_wire_dynamic_pruning`). Only integer, floating and string keys, whose
    footer min/max compare in the value domain."""
    if not conf.get("spark.rapids.sql.dynamicFilePruning.enabled") or \
            plan.join_type not in _DPP_SAFE:
        return
    from ..io.dynamic_pruning import DynamicKeyFilter
    for i, lk in enumerate(plan.left_keys):
        if not isinstance(lk, AttributeReference):
            continue
        res = _dpp_scan_for_column(join.children[0], lk.col_name)
        if res is None:
            continue
        scan, scan_col = res
        dt = scan.output.types[scan.output.names.index(scan_col)]
        if not (T.is_integral(dt) or T.is_floating(dt) or dt == T.STRING):
            continue
        filt = DynamicKeyFilter(scan_col)
        scan.dynamic_filters.append(filt)
        join.dpp_filters.append((join._rk_ix[i], filt))
