"""Null-handling expressions (`spark_rapids_tpu/expr/nullexprs.py`: IsNull,
IsNotNull, IsNaN, Coalesce). Coalesce merges decimal128 limb rows whole."""

from __future__ import annotations

import torch

from .. import types as T
from .base import EvalContext, Expression, Vec, pad_common_width
from .cast import convert

__all__ = ["IsNull", "IsNotNull", "IsNaN", "Coalesce"]


class _NullTest(Expression):
    """A boolean that is never null."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(T.BOOLEAN, self._test(c),
                   torch.ones_like(c.validity))


class IsNull(_NullTest):
    def _test(self, c: Vec):
        return ~c.validity


class IsNotNull(_NullTest):
    def _test(self, c: Vec):
        return c.validity


class IsNaN(_NullTest):
    def _test(self, c: Vec):
        return torch.isnan(c.data) & c.validity


class Coalesce(Expression):
    """First non-null argument."""

    def __init__(self, *children):
        super().__init__(list(children))

    @property
    def data_type(self):
        return self.children[0].data_type

    @property
    def nullable(self):
        return all(c.nullable for c in self.children)

    def _compute(self, ctx: EvalContext, *vecs: Vec) -> Vec:
        out = vecs[0]
        for v in vecs[1:]:
            take_out = out.validity
            validity = out.validity | v.validity
            if out.is_string:
                od, vd = pad_common_width(out, v)
                out = Vec(out.dtype, torch.where(take_out[:, None], od, vd),
                          validity,
                          torch.where(take_out, out.lengths, v.lengths))
            else:
                pick = take_out[:, None] if out.data.dim() == 2 else take_out
                out = Vec(out.dtype, torch.where(
                    pick, out.data, convert(v.data, out.data.dtype)),
                    validity)
        return out
