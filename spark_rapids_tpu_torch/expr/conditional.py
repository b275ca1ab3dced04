"""Conditional expressions (`spark_rapids_tpu/expr/conditional.py`: If,
CaseWhen, Least, Greatest), non-ANSI.

Every branch is evaluated over every row and `_select` picks per row. The
JAX package narrows each branch's row mask under ANSI so that untaken rows
raise no error; this engine rejects ANSI mode at plan time, so no branch
needs its own context here. String branches of different width buckets
merge at the wider width, zero-padded (`pad_common_width`); decimal128
branches select whole limb rows. Least and Greatest over decimals of more
than 18 digits are refused at plan time (the JAX package compares their
limbs one by one).
"""

from __future__ import annotations

import torch

from .. import types as T
from .base import EvalContext, Expression, Literal, Vec, pad_common_width

__all__ = ["If", "CaseWhen", "Least", "Greatest"]


def _select(cond: torch.Tensor, then_v: Vec, else_v: Vec) -> Vec:
    """cond: bool data, already null-resolved to False."""
    validity = torch.where(cond, then_v.validity, else_v.validity)
    if then_v.is_string:
        td, ed = pad_common_width(then_v, else_v)
        return Vec(then_v.dtype, torch.where(cond[:, None], td, ed), validity,
                   torch.where(cond, then_v.lengths, else_v.lengths))
    dt = else_v.dtype if isinstance(then_v.dtype, T.NullType) else \
        then_v.dtype
    pick = cond[:, None] if then_v.data.dim() == 2 else cond  # limbs
    return Vec(dt, torch.where(pick, then_v.data,
                               else_v.data.to(then_v.data.dtype)), validity)


class If(Expression):
    def __init__(self, pred, then_expr, else_expr):
        super().__init__([pred, then_expr, else_expr])

    @property
    def data_type(self):
        return self.children[1].data_type

    @property
    def nullable(self):
        return self.children[1].nullable or self.children[2].nullable

    def _compute(self, ctx: EvalContext, p: Vec, t: Vec, e: Vec) -> Vec:
        return _select(p.data & p.validity, t, e)  # null predicate -> else


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 ...] [ELSE ve] END.
    branches: (cond_expr, value_expr) pairs; a missing else is null."""

    def __init__(self, branches, else_expr=None):
        branches = list(branches)
        if else_expr is None:
            else_expr = Literal(None, branches[0][1].data_type)
        flat = []
        for c, v in branches:
            flat += [c, v]
        flat.append(else_expr)
        super().__init__(flat)

    @property
    def data_type(self):
        # children: [c0, v0, c1, v1, ..., else]
        return self.children[1].data_type

    @property
    def nullable(self):
        return True

    def _compute(self, ctx: EvalContext, *vecs: Vec) -> Vec:
        out = vecs[-1]
        # fold right to left so that earlier branches win
        for i in range((len(vecs) - 1) // 2 - 1, -1, -1):
            c, v = vecs[2 * i], vecs[2 * i + 1]
            out = _select(c.data & c.validity, v, out)
        return out


class _MinMaxN(Expression):
    """least/greatest of numeric values: nulls are skipped (null only when
    all are null); Spark NaN ordering."""

    def __init__(self, *children):
        super().__init__(list(children))

    @property
    def data_type(self):
        return self.children[0].data_type

    def _compute(self, ctx: EvalContext, *vecs: Vec) -> Vec:
        out = vecs[0]
        for v in vecs[1:]:
            a, b = out.data, v.data.to(out.data.dtype)
            better = self._cmp_float(a, b) if T.is_floating(out.dtype) \
                else self._cmp(a, b)
            take_a = (better & out.validity & v.validity) | \
                (out.validity & ~v.validity)
            out = Vec(out.dtype, torch.where(take_a, a, b),
                      out.validity | v.validity)
        return out


class Least(_MinMaxN):
    def _cmp(self, a, b):
        return a <= b

    def _cmp_float(self, a, b):
        return (a <= b) | torch.isnan(b)


class Greatest(_MinMaxN):
    def _cmp(self, a, b):
        return a >= b

    def _cmp_float(self, a, b):
        return (a >= b) | torch.isnan(a)
