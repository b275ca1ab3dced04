"""Math expressions (`spark_rapids_tpu/expr/math_.py`).

The unary and binary functions take their operands as DOUBLE and give
DOUBLE. Spark's null-on-domain: log, log10, log2 of x <= 0, log1p of x <=
-1 and the two-argument log of a base or value <= 0 (or base 1) are
null, not NaN; sqrt of a negative is NaN. The transcendentals are CUDA's
libdevice on the card and glibc on the host, a few ULP from the JVM's
StrictMath (the planner marks them incompat, as the JAX rules do); sqrt
(numpy's on the host: torch's CPU sqrt is not correctly rounded),
signum, floor, ceil, rint, round and bround are exact.

Floor and Ceil of an integral type are the value; of a FLOAT or DOUBLE a
LONG by Java's `(long)` rule (`cast.convert`): NaN is 0 and the
infinities and values past the range clamp. The JAX engine's device
gives the same; its CPU engine gives INT64_MIN for NaN (ROADMAP.md
"Known differences"). Round is HALF_UP and BRound HALF_EVEN at a literal
scale, through the JAX formula on the double; an integral value at scale
>= 0 is itself. Round and BRound, Floor and Ceil, and every function
here over a decimal operand are refused at plan time (the JAX engine
reads the unscaled value).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import types as T
from ..columnar.column import torch_dtype
from .base import EvalContext, Expression, Vec, and_validity, ieee_div
from .cast import convert

__all__ = ["UnaryMath", "Sqrt", "Exp", "Log", "Log10", "Log2", "Sin", "Cos",
           "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh", "Cbrt",
           "ToDegrees", "ToRadians", "Signum", "Expm1", "Log1p", "Rint",
           "Cot", "Pow", "Atan2", "Hypot", "Logarithm", "Floor", "Ceil",
           "Round", "BRound"]


class UnaryMath(Expression):
    """DOUBLE -> DOUBLE elementwise; `null_domain(a)` marks the inputs
    whose result is null."""

    null_domain = None

    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        return T.DOUBLE

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        a = c.data.to(torch.float64)
        validity = c.validity
        if self.null_domain is not None:
            bad = self.null_domain(a)
            validity = validity & ~bad
            a = torch.where(bad, 1.0, a)
        return Vec(T.DOUBLE, self._op(a), validity)

    def _op(self, a: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _unary(name: str, op, null_domain=None, doc: str = ""):
    cls = type(name, (UnaryMath,), {
        "_op": staticmethod(op), "__doc__": doc or None,
        "null_domain": None if null_domain is None
        else staticmethod(null_domain)})
    cls.__module__ = __name__
    return cls


def _not_positive(a):
    return a <= 0.0


def _cbrt(a: torch.Tensor) -> torch.Tensor:
    """The real cube root (torch has none): a = m 2^(3k + r) with m 2^r in
    [0.5, 4), the root of that by pow and one Newton step, times 2^k; 0,
    the infinities and NaN pass through."""
    m, e = torch.frexp(a)
    e = e.to(torch.int64)
    k = torch.div(e, 3, rounding_mode="floor")
    x = torch.ldexp(m, e - 3 * k)
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    y = torch.where(x == 0, 1.0, y)
    y = y - (y * y * y - x) / (3.0 * y * y)
    return torch.where(torch.isfinite(a) & (a != 0), torch.ldexp(y, k), a)


def _hyperbolic(fn, odd: bool):
    """sinh or cosh: past |a| = 709, where torch's CPU kernels overflow
    early, e^(|a|/2) / 2 * e^(|a|/2), which overflows only where the
    result does (a few ULP)."""
    def op(a: torch.Tensor) -> torch.Tensor:
        big = a.abs() > 709.0
        half = torch.exp(torch.where(big, a.abs() * 0.5, 0.0))
        tail = half * 0.5 * half
        return torch.where(big, torch.sign(a) * tail if odd else tail,
                           fn(a))
    return op


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root. torch's CPU kernel (SLEEF, 0.5001
    ULP) is not, so on the host numpy's takes its place; CUDA's sqrt is
    IEEE's."""
    if a.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(a.contiguous().numpy()))
    return torch.sqrt(a)


def _signum(a: torch.Tensor) -> torch.Tensor:
    """Math.signum: NaN and the signed zeros are themselves (torch.sign
    makes NaN 0)."""
    return torch.where(a > 0, 1.0, torch.where(a < 0, -1.0, a))


Sqrt = _unary("Sqrt", _sqrt)
Exp = _unary("Exp", torch.exp)
Log = _unary("Log", torch.log, _not_positive)
Log10 = _unary("Log10", torch.log10, _not_positive)
Log2 = _unary("Log2", torch.log2, _not_positive)
Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", _hyperbolic(torch.sinh, odd=True))
Cosh = _unary("Cosh", _hyperbolic(torch.cosh, odd=False))
Tanh = _unary("Tanh", torch.tanh)
Cbrt = _unary("Cbrt", _cbrt)
ToDegrees = _unary("ToDegrees", lambda a: a * (180.0 / math.pi))
ToRadians = _unary("ToRadians", lambda a: a * (math.pi / 180.0))
Signum = _unary("Signum", _signum)
Expm1 = _unary("Expm1", torch.expm1)
Log1p = _unary("Log1p", torch.log1p, lambda a: a <= -1.0)
Rint = _unary("Rint", torch.round, doc="rint: half to even, as Math.rint.")
Cot = _unary("Cot", lambda a: 1.0 / torch.tan(a))


class _BinaryMath(Expression):
    """(DOUBLE, DOUBLE) -> DOUBLE elementwise."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def data_type(self):
        return T.DOUBLE

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        return Vec(T.DOUBLE, self._op(l.data.to(torch.float64),
                                      r.data.to(torch.float64)),
                   and_validity(l.validity, r.validity))

    def _op(self, a, b):
        raise NotImplementedError


class Pow(_BinaryMath):
    def _op(self, a, b):
        return torch.pow(a, b)


class Atan2(_BinaryMath):
    def _op(self, a, b):
        return torch.atan2(a, b)


class Hypot(_BinaryMath):
    def _op(self, a, b):
        return torch.hypot(a, b)


class Logarithm(_BinaryMath):
    """log(base, x): null for x <= 0, base <= 0 or base 1."""

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        base = l.data.to(torch.float64)
        x = r.data.to(torch.float64)
        bad = (x <= 0) | (base <= 0) | (base == 1.0)
        data = torch.log(torch.where(bad, 1.0, x)) / \
            torch.log(torch.where(bad, 2.0, base))
        return Vec(T.DOUBLE, data,
                   and_validity(l.validity, r.validity) & ~bad)


class _FloorCeil(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        t = self.children[0].data_type
        return t if T.is_integral(t) else T.LONG

    def _compute(self, ctx, c: Vec) -> Vec:
        if T.is_integral(c.dtype):
            return c
        return Vec(T.LONG, convert(self._op(c.data.to(torch.float64)),
                                   torch.int64), c.validity)


class Floor(_FloorCeil):
    _op = staticmethod(torch.floor)


class Ceil(_FloorCeil):
    _op = staticmethod(torch.ceil)


class _RoundBase(Expression):
    def __init__(self, child, scale: int = 0):
        super().__init__([child])
        self.scale = scale

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.scale})"

    @property
    def data_type(self):
        return self.children[0].data_type

    def _compute(self, ctx, c: Vec) -> Vec:
        if T.is_integral(c.dtype) and self.scale >= 0:
            return c
        p = 10.0 ** self.scale
        out = self._round(c.data.to(torch.float64), p)
        return Vec(c.dtype, convert(out, torch_dtype(c.dtype)), c.validity)


class Round(_RoundBase):
    """round(x, d) HALF_UP: sign(x) * floor(|x| * 10^d + 0.5) / 10^d."""

    @staticmethod
    def _round(a, p):
        return ieee_div(_signum(a) * torch.floor(torch.abs(a) * p + 0.5), p)


class BRound(_RoundBase):
    """bround(x, d) HALF_EVEN: round(x * 10^d) / 10^d."""

    @staticmethod
    def _round(a, p):
        return ieee_div(torch.round(a * p), p)
