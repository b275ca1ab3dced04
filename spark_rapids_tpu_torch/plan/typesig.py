"""Type-support signatures (`spark_rapids_tpu/plan/typesig.py`; reference
`TypeChecks.scala` TypeSig `:171`).

A TypeSig names the data types an exec or expression rule takes on the
device; tagging holds a node's output types against it and records the
reason in the JAX wording. The constructors are the ones the rules of
plan/overrides.py use. A nested type is refused before tagging (the port
carries none), so the nested branches only keep the JAX reasons.
"""

from __future__ import annotations

from typing import Iterable, Optional, Set, Type

from .. import types as T

__all__ = ["TypeSig"]

_ALL_BASIC = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
              T.LongType, T.FloatType, T.DoubleType, T.StringType,
              T.DateType, T.TimestampType, T.NullType)


class TypeSig:
    def __init__(self, classes: Iterable[Type] = (), decimal_max: int = 0):
        self.classes: Set[Type] = set(classes)
        self.decimal_max = decimal_max

    @staticmethod
    def all_basic(decimal_max: int = 18) -> "TypeSig":
        return TypeSig(_ALL_BASIC, decimal_max=decimal_max)

    @staticmethod
    def all_with_nested(decimal_max: int = 18) -> "TypeSig":
        return TypeSig(_ALL_BASIC + (T.ArrayType, T.StructType, T.MapType),
                       decimal_max=decimal_max)

    @staticmethod
    def numeric(decimal_max: int = 18) -> "TypeSig":
        return TypeSig((T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                        T.FloatType, T.DoubleType), decimal_max=decimal_max)

    @staticmethod
    def integral() -> "TypeSig":
        return TypeSig((T.ByteType, T.ShortType, T.IntegerType, T.LongType))

    @staticmethod
    def orderable(decimal_max: int = 18) -> "TypeSig":
        return TypeSig(_ALL_BASIC, decimal_max=decimal_max)

    def support_reason(self, dt: T.DataType) -> Optional[str]:
        """None if the sig takes `dt`; else the reason."""
        if isinstance(dt, T.DecimalType):
            if self.decimal_max <= 0:
                return f"{dt.simple_string()} is not supported"
            if dt.precision > self.decimal_max:
                return (f"{dt.simple_string()} exceeds max supported "
                        f"precision {self.decimal_max}")
            return None
        if isinstance(dt, T.ArrayType):
            if T.ArrayType not in self.classes:
                return f"nested type {dt.simple_string()} is not supported yet"
            return self.support_reason(dt.element_type)
        if isinstance(dt, T.StructType):
            if T.StructType not in self.classes:
                return f"nested type {dt.simple_string()} is not supported yet"
            for f in dt.fields:
                r = self.support_reason(f.data_type)
                if r:
                    return r
            return None
        if isinstance(dt, T.MapType):
            if T.MapType not in self.classes:
                return f"map type {dt.simple_string()} is not supported yet"
            return self.support_reason(dt.key_type) or \
                self.support_reason(dt.value_type)
        if type(dt) in self.classes:
            return None
        return f"{dt.simple_string()} is not supported"
