"""Conditional expressions (`spark_rapids_tpu/expr/conditional.py`: If,
CaseWhen, Least, Greatest).

Every branch is evaluated over every row and `_select` picks per row.
Spark evaluates only the branch a row takes, so under ANSI each branch is
evaluated with its row mask narrowed to the rows that take it
(`_branch_ctx`): an error in a row that takes another branch never
raises, and a nested CASE narrows again. A branch of another type
converts to the result's as Java does (`cast.convert`: a DOUBLE into an
INT result clamps, NaN to 0). String branches of different width buckets
merge at the wider width, zero-padded (`pad_common_width`); decimal128
branches select whole limb rows. Least and Greatest over decimals of more
than 18 digits are refused at plan time (the JAX package compares their
limbs one by one).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import types as T
from .base import EvalContext, Expression, Literal, Vec, pad_common_width
from .cast import convert

__all__ = ["If", "CaseWhen", "Least", "Greatest"]


def _branch_ctx(ctx: EvalContext, taken: torch.Tensor) -> EvalContext:
    """The context of a branch taken where `taken` (JAX `_branch_ctx`);
    the same context outside ANSI. The error list is shared."""
    if not ctx.ansi:
        return ctx
    return dataclasses.replace(ctx, row_mask=ctx.row_mask & taken)


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
                               convert(else_v.data, then_v.data.dtype)),
               validity)


class If(Expression):
    def __init__(self, pred, then_expr, else_expr):
        super().__init__([pred, then_expr, else_expr])

    @property
    def data_type(self):
        return self.children[1].data_type

    @property
    def nullable(self):
        return self.children[1].nullable or self.children[2].nullable

    def eval(self, ctx: EvalContext, batch_vecs) -> Vec:
        p = self.children[0].eval(ctx, batch_vecs)
        cond = p.data & p.validity  # null predicate -> else
        t = self.children[1].eval(_branch_ctx(ctx, cond), batch_vecs)
        e = self.children[2].eval(_branch_ctx(ctx, ~cond), batch_vecs)
        return _select(cond, t, e)


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

    def eval(self, ctx: EvalContext, batch_vecs) -> Vec:
        """Every condition first, then each value under the rows its
        branch takes (not taken by an earlier one), then the else."""
        ch = self.children
        conds, taken_before = [], None
        for c_expr in ch[:-1:2]:
            c = c_expr.eval(ctx, batch_vecs)
            cond = c.data & c.validity
            conds.append((cond, cond if taken_before is None
                          else cond & ~taken_before))
            taken_before = cond if taken_before is None \
                else taken_before | cond
        vals = [v_expr.eval(_branch_ctx(ctx, eff), batch_vecs)
                for v_expr, (_, eff) in zip(ch[1::2], conds)]
        out = ch[-1].eval(_branch_ctx(ctx, ~taken_before), batch_vecs)
        # fold right to left so that earlier branches win
        for (cond, _), v in zip(reversed(conds), reversed(vals)):
            out = _select(cond, v, out)
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
            a, b = out.data, convert(v.data, out.data.dtype)
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
