from .base import (Expression, LeafExpression, Literal,  # noqa: F401
                   AttributeReference, BoundReference, Alias, Vec,
                   EvalContext, bind_references, output_name)
from .arithmetic import Add, Subtract, Multiply  # noqa: F401
from .predicates import (EqualTo, LessThan, LessThanOrEqual,  # noqa: F401
                         GreaterThan, GreaterThanOrEqual, And, Or, Not)
from .hashing import hash_vecs  # noqa: F401
from .aggregates import AggregateFunction, Sum, Count, Min, Max  # noqa: F401


def col(name):  # convenience constructors for tests / DataFrame API
    return AttributeReference(name)


def lit(value, dtype=None):
    return Literal(value, dtype)
