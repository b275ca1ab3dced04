"""Spark-compatible data type system.

Mirrors the type surface the reference supports on GPU (see SURVEY.md §2.2 TypeChecks /
`sql-plugin/.../TypeChecks.scala:171` TypeSig): boolean, byte/short/int/long, float/double,
string, date, timestamp, decimal, null, plus nested array/struct/map (nested types are
represented but only partially executable on device in this round).

Physical mapping (TPU-first):
  BOOLEAN   -> bool_
  BYTE      -> int8        SHORT -> int16     INT -> int32     LONG -> int64
  FLOAT     -> float32     DOUBLE -> float64 (on TPU, f64 computes as f32 pairs; we keep
                           float32 device compute for DOUBLE only when explicitly allowed,
                           default is exact float64 via XLA's f64 emulation on host path)
  STRING    -> uint8[n, w] byte matrix + int32 lengths
  DATE      -> int32 days since epoch (Spark semantics)
  TIMESTAMP -> int64 microseconds since epoch (Spark semantics)
  DECIMAL(p<=18, s) -> int64 unscaled; DECIMAL(p>18) -> int64[n, 2] limbs: the
                        signed high word, then the low word's bit pattern
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "DataType", "NumericType", "IntegralType", "FractionalType",
    "BooleanType", "ByteType", "ShortType", "IntegerType", "LongType",
    "FloatType", "DoubleType", "StringType", "BinaryType", "DateType",
    "TimestampType", "DecimalType", "NullType", "ArrayType", "StructType",
    "StructField", "MapType", "BOOLEAN", "BYTE", "SHORT", "INT", "LONG",
    "FLOAT", "DOUBLE", "STRING", "BINARY", "DATE", "TIMESTAMP", "NULL",
]


@dataclasses.dataclass(frozen=True)
class DataType:
    """Base of the Spark-style type lattice."""

    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    # --- physical properties -------------------------------------------------
    @property
    def np_dtype(self) -> Optional[np.dtype]:
        """numpy dtype of the primary device buffer, None for non-primitive."""
        return None

    @property
    def is_primitive(self) -> bool:
        return self.np_dtype is not None

    @property
    def is_nested(self) -> bool:
        return isinstance(self, (ArrayType, StructType, MapType))

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return self.simple_string()


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class BooleanType(DataType):
    @property
    def np_dtype(self):
        return np.dtype(np.bool_)


@dataclasses.dataclass(frozen=True, repr=False)
class ByteType(IntegralType):
    @property
    def np_dtype(self):
        return np.dtype(np.int8)


@dataclasses.dataclass(frozen=True, repr=False)
class ShortType(IntegralType):
    @property
    def np_dtype(self):
        return np.dtype(np.int16)


@dataclasses.dataclass(frozen=True, repr=False)
class IntegerType(IntegralType):
    @property
    def np_dtype(self):
        return np.dtype(np.int32)


@dataclasses.dataclass(frozen=True, repr=False)
class LongType(IntegralType):
    @property
    def np_dtype(self):
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True, repr=False)
class FloatType(FractionalType):
    @property
    def np_dtype(self):
        return np.dtype(np.float32)


@dataclasses.dataclass(frozen=True, repr=False)
class DoubleType(FractionalType):
    @property
    def np_dtype(self):
        return np.dtype(np.float64)


@dataclasses.dataclass(frozen=True, repr=False)
class StringType(DataType):
    """Variable-length UTF-8. Device layout: uint8[n, width] + int32[n] lengths."""

    @property
    def np_dtype(self):
        return None

    def simple_string(self) -> str:
        return "string"


@dataclasses.dataclass(frozen=True, repr=False)
class BinaryType(DataType):
    def simple_string(self) -> str:
        return "binary"


@dataclasses.dataclass(frozen=True, repr=False)
class DateType(DataType):
    """Days since 1970-01-01 (proleptic Gregorian), stored int32."""

    @property
    def np_dtype(self):
        return np.dtype(np.int32)


@dataclasses.dataclass(frozen=True, repr=False)
class TimestampType(DataType):
    """Microseconds since epoch UTC, stored int64 (Spark TimestampType)."""

    @property
    def np_dtype(self):
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True, repr=False)
class DecimalType(FractionalType):
    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18

    def __post_init__(self):
        if not (0 < self.precision <= self.MAX_PRECISION):
            raise ValueError(f"decimal precision out of range: {self.precision}")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"decimal scale out of range: {self.scale}")

    @property
    def np_dtype(self):
        # <=18 digits fits in an int64 unscaled value; wider uses limb pairs.
        if self.precision <= self.MAX_LONG_DIGITS:
            return np.dtype(np.int64)
        return None

    def simple_string(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    @staticmethod
    def bounded(precision: int, scale: int) -> "DecimalType":
        return DecimalType(min(precision, DecimalType.MAX_PRECISION),
                           min(scale, DecimalType.MAX_PRECISION))


@dataclasses.dataclass(frozen=True, repr=False)
class NullType(DataType):
    def simple_string(self) -> str:
        return "void"


@dataclasses.dataclass(frozen=True, repr=False)
class ArrayType(DataType):
    element_type: DataType = dataclasses.field(default_factory=lambda: NullType())
    contains_null: bool = True

    def simple_string(self) -> str:
        return f"array<{self.element_type.simple_string()}>"


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True, repr=False)
class StructType(DataType):
    fields: Tuple[StructField, ...] = ()

    def simple_string(self) -> str:
        inner = ",".join(f"{f.name}:{f.data_type.simple_string()}" for f in self.fields)
        return f"struct<{inner}>"

    def field_names(self):
        return [f.name for f in self.fields]


@dataclasses.dataclass(frozen=True, repr=False)
class MapType(DataType):
    key_type: DataType = dataclasses.field(default_factory=lambda: NullType())
    value_type: DataType = dataclasses.field(default_factory=lambda: NullType())
    value_contains_null: bool = True

    def simple_string(self) -> str:
        return (f"map<{self.key_type.simple_string()},"
                f"{self.value_type.simple_string()}>")


# Singletons, Spark-style.
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

_INTEGRAL_ORDER = {ByteType: 0, ShortType: 1, IntegerType: 2, LongType: 3}

_SIMPLE_NAMES = {
    "boolean": BOOLEAN, "byte": BYTE, "short": SHORT, "integer": INT,
    "long": LONG, "float": FLOAT, "double": DOUBLE, "string": STRING,
    "binary": BINARY, "date": DATE, "timestamp": TIMESTAMP, "void": NULL,
}


def parse_type(s: str) -> DataType:
    """Inverse of simple_string() for flat types (wire metadata / test specs).
    Nested types are not wire-serialized (they are not device-backed yet)."""
    s = s.strip()
    if s in _SIMPLE_NAMES:
        return _SIMPLE_NAMES[s]
    if s.startswith("decimal(") and s.endswith(")"):
        p, sc = s[len("decimal("):-1].split(",")
        return DecimalType(int(p), int(sc))
    raise ValueError(f"cannot parse type string {s!r}")


def is_dec128(dt: DataType) -> bool:
    """A decimal held as two int64 limbs (precision > 18)."""
    return isinstance(dt, DecimalType) and \
        dt.precision > DecimalType.MAX_LONG_DIGITS


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, IntegralType)


def is_floating(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


def is_numeric(dt: DataType) -> bool:
    return isinstance(dt, NumericType)


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Binary-arithmetic result type, matching Spark's implicit widening for the
    non-decimal numeric lattice (byte<short<int<long<float<double)."""
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise ValueError("decimal promotion handled by the expression layer")
    if isinstance(a, DoubleType) or isinstance(b, DoubleType):
        return DOUBLE
    if isinstance(a, FloatType) or isinstance(b, FloatType):
        return FLOAT
    oa = _INTEGRAL_ORDER[type(a)]
    ob = _INTEGRAL_ORDER[type(b)]
    return (a, b)[ob > oa]


def from_arrow(at) -> DataType:
    """Map a pyarrow DataType to ours."""
    import pyarrow as pa
    if pa.types.is_boolean(at):
        return BOOLEAN
    if pa.types.is_int8(at):
        return BYTE
    if pa.types.is_int16(at):
        return SHORT
    if pa.types.is_int32(at):
        return INT
    if pa.types.is_int64(at):
        return LONG
    if pa.types.is_float32(at):
        return FLOAT
    if pa.types.is_float64(at):
        return DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return BINARY
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_timestamp(at):
        return TIMESTAMP
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    if pa.types.is_null(at):
        return NULL
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow(at.value_type))
    if pa.types.is_struct(at):
        return StructType(tuple(
            StructField(f.name, from_arrow(f.type), f.nullable) for f in at))
    if pa.types.is_map(at):
        return MapType(from_arrow(at.key_type), from_arrow(at.item_type))
    raise TypeError(f"unsupported arrow type: {at}")


def to_arrow(dt: DataType):
    import pyarrow as pa
    m = {
        BooleanType: pa.bool_(), ByteType: pa.int8(), ShortType: pa.int16(),
        IntegerType: pa.int32(), LongType: pa.int64(), FloatType: pa.float32(),
        DoubleType: pa.float64(), StringType: pa.string(), BinaryType: pa.binary(),
        DateType: pa.date32(), TimestampType: pa.timestamp("us", tz="UTC"),
        NullType: pa.null(),
    }
    t = type(dt)
    if t in m:
        return m[t]
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow(dt.element_type))
    if isinstance(dt, StructType):
        return pa.struct([pa.field(f.name, to_arrow(f.data_type), f.nullable)
                          for f in dt.fields])
    if isinstance(dt, MapType):
        return pa.map_(to_arrow(dt.key_type), to_arrow(dt.value_type))
    raise TypeError(f"unsupported type: {dt}")
