"""Expression IR core (`spark_rapids_tpu/expr/base.py`).

The JAX package writes each expression once over an array namespace (numpy
for its CPU oracle, jax.numpy for the device). This engine has one backend:
every kernel is a plain function on torch tensors, and the device is the
one the input tensors live on. Evaluation operates on `Vec` (dtype + data
+ validity); the exec layer converts `Column` <-> `Vec` without copies.
"""

from __future__ import annotations

import dataclasses
import decimal as _decimal
from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.column import Column, torch_dtype
from ..columnar.padding import width_bucket

__all__ = ["Vec", "EvalContext", "ansi_raise", "Expression",
           "LeafExpression", "Literal", "AttributeReference",
           "BoundReference", "Alias", "bind_references", "output_name",
           "and_validity", "ieee_div", "require_flat_strings",
           "pad_common_width", "pad_width"]


@dataclasses.dataclass
class Vec:
    """dtype + data + validity, plus int32 lengths for a STRING value (data
    is then the uint8[cap, w] byte matrix, zero past each row's length).
    A long-string value (columnar/strings.py) also has `overflow`, (blob,
    tail_start): a row move gathers tail_start and passes the blob
    through; a kernel that reads bytes goes through require_flat_strings."""
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    overflow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)

    @staticmethod
    def from_column(col: Column) -> "Vec":
        return Vec(col.dtype, col.data, col.validity, col.lengths,
                   col.overflow)

    def to_column(self) -> Column:
        return Column(self.dtype, self.data, self.validity, self.lengths,
                      self.overflow)

    def gather(self, idx) -> "Vec":
        """Rows by index or slice: the blob of a long string stays shared,
        only its tail offsets move."""
        return Vec(self.dtype, self.data[idx], self.validity[idx],
                   None if self.lengths is None else self.lengths[idx],
                   None if self.overflow is None else
                   (self.overflow[0], self.overflow[1][idx]))

    def with_validity(self, validity: torch.Tensor) -> "Vec":
        return Vec(self.dtype, self.data, validity, self.lengths,
                   self.overflow)

    def map_rows(self, fn, blob_fn=None) -> "Vec":
        """fn over every row-aligned buffer, the blob through blob_fn (or
        as it is): JAX `vec_map_arrays`."""
        return Vec.from_column(self.to_column().map_rows(fn, blob_fn))


def require_flat_strings(v: Vec, op: str) -> Vec:
    """Gate for the kernels that read every byte of a string (equality,
    ordering, hashing, sort keys, merges, the string functions): a value
    in the long-string layout raises CpuFallbackRequired, and the session
    reruns the plan on the host, whose strings are the flat matrix (JAX
    `require_flat_strings`, the per-op fallback)."""
    if not v.is_string:
        return v
    if v.overflow is not None:
        from ..errors import CpuFallbackRequired
        raise CpuFallbackRequired(
            f"{op} needs full string bytes; column uses the long-string "
            "overflow layout")
    if v.lengths is None or v.data.dim() != 2 or v.data.dtype != torch.uint8:
        raise TypeError(f"{op}: a string value must be a uint8 byte matrix "
                        "with lengths")
    return v


def pad_common_width(a: Vec, b: Vec):
    """The byte matrices of two string values zero-padded to one width
    (`spark_rapids_tpu/expr/strings.py` pad_common_width). Every string
    compare and merge goes through here; zero padding keeps the bytes past
    each row's length zero."""
    require_flat_strings(a, "string byte-matrix op")
    require_flat_strings(b, "string byte-matrix op")
    w = max(a.data.shape[1], b.data.shape[1])
    return pad_width(a.data, w), pad_width(b.data, w)


def pad_width(data: torch.Tensor, w: int) -> torch.Tensor:
    """uint8[cap, v] -> uint8[cap, w] (w >= v), zeros on the right. A row
    broadcast to every row (a string literal) stays a broadcast view."""
    if data.shape[1] == w:
        return data
    if data.shape[0] > 1 and data.stride(0) == 0:
        return pad_width(data[:1], w).expand(data.shape[0], -1)
    return torch.nn.functional.pad(data, (0, w - data.shape[1]))


@dataclasses.dataclass
class EvalContext:
    """row_mask: bool[cap] live-row mask of the batch being evaluated; its
    device and length give literals theirs. ansi: Spark's ANSI mode.
    errors: the (device bool, message) pairs `ansi_raise` appends, in
    evaluation order; the exec reads them after the batch
    (exec/base.py `read_flags`), so nothing here waits for the device."""
    row_mask: torch.Tensor
    ansi: bool = False
    errors: list = dataclasses.field(default_factory=list)

    @property
    def device(self) -> torch.device:
        return self.row_mask.device


def ansi_raise(ctx: EvalContext, flag: torch.Tensor, message: str,
               masked: bool = True) -> None:
    """Report an ANSI runtime error for the rows where `flag` is true (JAX
    `ansi_raise`): the flag, reduced on the device, joins ctx.errors.
    Rows outside ctx.row_mask never raise: past the row count a padded
    batch holds arbitrary values, and an If/CaseWhen branch narrows the
    mask to the rows that take it. `masked=False` is for flags over
    groups rather than rows (the Sum accumulator)."""
    if masked:
        flag = flag & ctx.row_mask
    ctx.errors.append((flag.any(), message))


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, as Java divides: torch's CUDA kernel multiplies
    by the reciprocal of a Python-number divisor, a ULP off in some rows,
    so the divisor goes in as a tensor on x's device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def and_validity(*vs) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


class Expression:
    """Base expression node. Subclasses define `children`, `data_type`, and
    `_compute(ctx, *child_vecs) -> Vec`."""

    def __init__(self, children: Sequence["Expression"] = ()):
        self.children: List[Expression] = list(children)

    @property
    def data_type(self) -> T.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    @property
    def name(self) -> str:
        return type(self).__name__

    # can this expression's kernel take the long-string layout? No
    # expression does (as in the JAX package): eval() sends any other to
    # the host rather than let a byte-matrix kernel stop at the head width
    accepts_long_strings = False

    def eval(self, ctx: EvalContext, batch_vecs: Sequence[Vec]) -> Vec:
        child_results = [c.eval(ctx, batch_vecs) for c in self.children]
        if not self.accepts_long_strings:
            for v in child_results:
                if v.overflow is not None:
                    require_flat_strings(v, self.name)
        return self._compute(ctx, *child_results)

    def _compute(self, ctx: EvalContext, *children: Vec) -> Vec:
        raise NotImplementedError(type(self).__name__)

    def transform_up(self, fn) -> "Expression":
        new_children = [c.transform_up(fn) for c in self.children]
        unchanged = all(a is b for a, b in zip(new_children, self.children))
        node = self if unchanged else self.with_children(new_children)
        return fn(node)

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        import copy
        node = copy.copy(self)
        node.children = list(children)
        return node

    def collect(self, pred) -> List["Expression"]:
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    def __repr__(self):
        if not self.children:
            return self.name
        return f"{self.name}({', '.join(map(repr, self.children))})"

    # --- operator sugar for the DataFrame frontend ---------------------------
    @staticmethod
    def _wrap(v) -> "Expression":
        return v if isinstance(v, Expression) else Literal(v)

    def __add__(self, o):
        from .arithmetic import Add
        return Add(self, self._wrap(o))

    def __sub__(self, o):
        from .arithmetic import Subtract
        return Subtract(self, self._wrap(o))

    def __mul__(self, o):
        from .arithmetic import Multiply
        return Multiply(self, self._wrap(o))

    def __truediv__(self, o):
        from .arithmetic import Divide
        return Divide(self, self._wrap(o))

    def __mod__(self, o):
        from .arithmetic import Remainder
        return Remainder(self, self._wrap(o))

    def __neg__(self):
        from .arithmetic import UnaryMinus
        return UnaryMinus(self)

    def __eq__(self, o):  # type: ignore[override]
        from .predicates import EqualTo
        return EqualTo(self, self._wrap(o))

    def __ne__(self, o):  # type: ignore[override]
        from .predicates import EqualTo, Not
        return Not(EqualTo(self, self._wrap(o)))

    def __lt__(self, o):
        from .predicates import LessThan
        return LessThan(self, self._wrap(o))

    def __le__(self, o):
        from .predicates import LessThanOrEqual
        return LessThanOrEqual(self, self._wrap(o))

    def __gt__(self, o):
        from .predicates import GreaterThan
        return GreaterThan(self, self._wrap(o))

    def __ge__(self, o):
        from .predicates import GreaterThanOrEqual
        return GreaterThanOrEqual(self, self._wrap(o))

    def __and__(self, o):
        from .predicates import And
        return And(self, self._wrap(o))

    def __or__(self, o):
        from .predicates import Or
        return Or(self, self._wrap(o))

    def __invert__(self):
        from .predicates import Not
        return Not(self)

    def __radd__(self, o):
        return self._wrap(o).__add__(self)

    def __rsub__(self, o):
        return self._wrap(o).__sub__(self)

    def __rmul__(self, o):
        return self._wrap(o).__mul__(self)

    def __bool__(self):
        raise ValueError(
            "Cannot convert an Expression to a bool. Use '&' for AND, '|' for "
            "OR, '~' for NOT when building conditions.")

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Expression":
        return Alias(self, name)

    def cast(self, dt) -> "Expression":
        from .cast import Cast
        return Cast(self, dt)


class LeafExpression(Expression):
    def __init__(self):
        super().__init__(())


def _infer_literal_type(v) -> T.DataType:
    if v is None:
        return T.NULL
    if isinstance(v, bool):
        return T.BOOLEAN
    if isinstance(v, int):
        return T.INT if -2**31 <= v < 2**31 else T.LONG
    if isinstance(v, float):
        return T.DOUBLE
    if isinstance(v, str):
        return T.STRING
    if isinstance(v, _decimal.Decimal):
        from .decimal128 import literal_type
        return literal_type(v)
    raise NotImplementedError(f"literal {v!r} of type {type(v).__name__} is "
                              "not supported by spark_rapids_tpu_torch yet")


class Literal(LeafExpression):
    """A constant. A decimal literal's value is a `decimal.Decimal` or its
    unscaled int; a timestamp literal's is microseconds since the epoch."""

    def __init__(self, value, dtype: Optional[T.DataType] = None):
        super().__init__()
        self.value = value
        self._dtype = _infer_literal_type(value) if dtype is None else dtype
        # device -> a string literal's uint8[1, w] bytes or a decimal
        # literal's int64[1] unscaled value
        self._rows = {}

    def _decimal_row(self, dev: torch.device) -> torch.Tensor:
        """The unscaled value, copied to each device once: int64[1], or
        int64[1, 2] limbs (hi, lo) past 18 digits."""
        row = self._rows.get(dev)
        if row is None:
            from .decimal128 import is_dec128, split_int, unscaled_int
            v = self.value
            if isinstance(v, _decimal.Decimal):
                v = unscaled_int(v, self._dtype.scale)
            v = [list(split_int(int(v)))] if is_dec128(self._dtype) else \
                [int(v)]
            row = self._rows[dev] = torch.tensor(v, dtype=torch.int64).to(dev)
        return row

    def _string_row(self, dev: torch.device) -> torch.Tensor:
        """The zero-tailed byte row, copied to each device once."""
        row = self._rows.get(dev)
        if row is None:
            b = self.value.encode("utf-8")
            row = torch.zeros((1, width_bucket(max(len(b), 1))),
                              dtype=torch.uint8)
            if b:  # torch.frombuffer refuses an empty buffer
                row[0, :len(b)] = torch.frombuffer(bytearray(b),
                                                   dtype=torch.uint8)
            row = self._rows[dev] = row.to(dev)
        return row

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def _compute(self, ctx: EvalContext, *children: Vec) -> Vec:
        n = ctx.row_mask.shape[0]
        dev = ctx.device
        if self.value is None:
            from ..columnar.batch import empty_column
            return Vec.from_column(empty_column(self._dtype, n, dev))
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        if isinstance(self._dtype, T.StringType):
            # broadcast, not materialised: compares, merges and gathers read
            # the one row; an op that needs its own buffer copies it
            return Vec(self._dtype, self._string_row(dev).expand(n, -1), ones,
                       torch.full((n,), len(self.value.encode("utf-8")),
                                  dtype=torch.int32, device=dev))
        if isinstance(self._dtype, T.DecimalType):
            # broadcast as a string literal is: one row, read by every row
            row = self._decimal_row(dev)
            return Vec(self._dtype, row.expand((n,) + row.shape[1:]), ones)
        return Vec(self._dtype, torch.full((n,), self.value,
                                           dtype=torch_dtype(self._dtype),
                                           device=dev), ones)

    def __repr__(self):
        if self._dtype == _infer_literal_type(self.value):
            return f"lit({self.value!r})"
        return f"lit({self.value!r}:{self._dtype.simple_string()})"


class AttributeReference(LeafExpression):
    """Named column reference (bind_references resolves it to an ordinal)."""

    def __init__(self, name: str, dtype: Optional[T.DataType] = None,
                 nullable: bool = True):
        super().__init__()
        self._name = name
        self._dtype = dtype
        self._nullable = nullable

    @property
    def data_type(self) -> T.DataType:
        if self._dtype is None:
            raise ValueError(f"unresolved attribute {self._name}")
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def col_name(self) -> str:
        return self._name

    def _compute(self, ctx, *children):
        raise RuntimeError(f"unbound attribute {self._name}; "
                           "call bind_references")

    def __repr__(self):
        return f"col({self._name})"


class BoundReference(LeafExpression):
    def __init__(self, ordinal: int, dtype: T.DataType, nullable: bool = True):
        super().__init__()
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def eval(self, ctx: EvalContext, batch_vecs: Sequence[Vec]) -> Vec:
        return batch_vecs[self.ordinal]

    def __repr__(self):
        return f"input[{self.ordinal}]"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        super().__init__([child])
        self.alias = alias

    @property
    def data_type(self):
        return self.children[0].data_type

    @property
    def nullable(self):
        return self.children[0].nullable

    def eval(self, ctx, batch_vecs):
        return self.children[0].eval(ctx, batch_vecs)

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.alias}"


def bind_references(expr: Expression, schema) -> Expression:
    """Resolve AttributeReference -> BoundReference against a Schema."""

    def fn(node):
        if isinstance(node, AttributeReference):
            i = schema.index_of(node.col_name)
            return BoundReference(i, schema.types[i], node._nullable)
        return node

    return expr.transform_up(fn)


def output_name(expr: Expression, default: str) -> str:
    if isinstance(expr, Alias):
        return expr.alias
    if isinstance(expr, AttributeReference):
        return expr.col_name
    return default
