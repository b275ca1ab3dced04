from .base import (Expression, LeafExpression, Literal,  # noqa: F401
                   AttributeReference, BoundReference, Alias, Vec,
                   EvalContext, bind_references, output_name)
from .arithmetic import (Add, Subtract, Multiply, Divide,  # noqa: F401
                         IntegralDivide, Remainder, Pmod, UnaryMinus, Abs)
from .cast import Cast  # noqa: F401
from .predicates import (EqualTo, LessThan, LessThanOrEqual,  # noqa: F401
                         GreaterThan, GreaterThanOrEqual, And, Or, Not,
                         In)
from .nullexprs import IsNull, IsNotNull, IsNaN, Coalesce  # noqa: F401
from .conditional import If, CaseWhen, Least, Greatest  # noqa: F401
from .hashing import hash_vecs  # noqa: F401
from .strings import (Length, Upper, Lower, Substring, Concat,  # noqa: F401
                      StartsWith, EndsWith, Contains, StringTrim,
                      StringTrimLeft, StringTrimRight)
from .regex import RLike, Like, RegExpReplace, RegExpExtract  # noqa: F401
from .strings_ext import (StringRepeat, StringLPad,  # noqa: F401
                          StringRPad, StringLocate, StringInstr,
                          StringReplace, StringTranslate, StringReverse,
                          ConcatWs, SubstringIndex, InitCap, Ascii, Chr,
                          Left, Right, StringSpace, BitLength, OctetLength,
                          FindInSet)
from .strings_more import (Overlay, Levenshtein, SoundEx,  # noqa: F401
                           FormatNumber, Empty2Null, Conv)
from .datetime_ import (Year, Month, DayOfMonth, Quarter,  # noqa: F401
                        DayOfWeek, WeekDay, DayOfYear, WeekOfYear, Hour,
                        Minute, Second, DateAdd, DateSub, DateDiff,
                        UnixTimestampFromTs, LastDay, AddMonths,
                        MonthsBetween, TruncDate, NextDay, DayName,
                        MonthName, TimestampSeconds, TimestampMillis,
                        TimestampMicros, DateFromUnixDate, UnixDate,
                        MakeDate, TruncTimestamp, DateFormat, FromUnixTime,
                        ToUnixTimestamp, UnixTimestamp)
from .math_ import (Sqrt, Exp, Log, Log10, Log2, Sin, Cos,  # noqa: F401
                    Tan, Asin, Acos, Atan, Sinh, Cosh, Tanh, Cbrt,
                    ToDegrees, ToRadians, Signum, Expm1, Log1p, Rint, Cot,
                    Pow, Atan2, Hypot, Logarithm, Floor, Ceil, Round,
                    BRound)
from .bitwise import (BitwiseAnd, BitwiseOr, BitwiseXor,  # noqa: F401
                      BitwiseNot, ShiftLeft, ShiftRight,
                      ShiftRightUnsigned)
from .aggregates import (AggregateFunction, Sum, Count, Min,  # noqa: F401
                         Max, Average, First, Last, CountDistinct,
                         VariancePop, VarianceSamp, StddevPop, StddevSamp,
                         CollectList, CollectSet, ApproximatePercentile,
                         CountIf, BoolAnd, BoolOr, BitAndAgg, BitOrAgg,
                         BitXorAgg, Skewness, Kurtosis)
from .windowexprs import (RowFrame, RangeFrame, default_frame,  # noqa: F401
                          is_value_range_frame, WindowFunction, RowNumber,
                          Rank, DenseRank, PercentRank, CumeDist, NTile,
                          Lead, Lag, NthValue, WindowAggregate,
                          bind_window_fn)


def col(name):  # convenience constructors for tests / DataFrame API
    return AttributeReference(name)


def lit(value, dtype=None):
    return Literal(value, dtype)
