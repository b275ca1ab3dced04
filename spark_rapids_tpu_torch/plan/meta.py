"""Meta wrapper tree (`spark_rapids_tpu/plan/meta.py`; reference
`RapidsMeta.scala`: RapidsMeta `:76`, SparkPlanMeta `:573`, BaseExprMeta
`:1003`).

A meta node wraps one plan node or expression and carries its tag result:
the reasons it will not run on the device. Conversion reads the tags
afterwards (tag, then convert), and `explain_lines` prints the tree with a
`*` for a device node and a `!` with its reasons for a host node, in the
JAX wording.
"""

from __future__ import annotations

from typing import List

from ..config import TpuConf
from ..expr.base import Expression

__all__ = ["BaseMeta", "ExprMeta", "PlanMeta"]


class BaseMeta:
    def __init__(self, conf: TpuConf):
        self.conf = conf
        self._reasons: List[str] = []

    def will_not_work(self, reason: str) -> None:
        if reason not in self._reasons:
            self._reasons.append(reason)

    @property
    def can_run_on_device(self) -> bool:
        return not self._reasons

    @property
    def reasons(self) -> List[str]:
        return list(self._reasons)


class ExprMeta(BaseMeta):
    def __init__(self, expr: Expression, conf: TpuConf, rule):
        super().__init__(conf)
        self.expr = expr
        self.rule = rule
        self.child_metas: List["ExprMeta"] = []

    def tag_for_device(self) -> None:
        from .overrides import lookup_expr_rule
        if self.rule is None:
            self.will_not_work(
                f"expression {self.expr.name} is not supported on TPU")
        else:
            if not self.conf.is_operator_enabled(self.rule.conf_key,
                                                 self.rule.incompat):
                why = "incompat" if self.rule.incompat else "disabled"
                self.will_not_work(
                    f"expression {self.expr.name} is {why}; enable with "
                    f"{self.rule.conf_key}=true")
            reason = self.rule.sig.support_reason(self.expr.data_type)
            if reason:
                self.will_not_work(
                    f"expression {self.expr.name}: output {reason}")
            if self.rule.tag_fn is not None:
                self.rule.tag_fn(self)
        for c in self.expr.children:
            m = lookup_expr_rule(c, self.conf)
            m.tag_for_device()
            self.child_metas.append(m)

    @property
    def all_reasons(self) -> List[str]:
        out = list(self._reasons)
        for c in self.child_metas:
            out.extend(c.all_reasons)
        return out


class PlanMeta(BaseMeta):
    def __init__(self, plan, conf: TpuConf, rule):
        super().__init__(conf)
        self.plan = plan
        self.rule = rule
        self.child_metas: List["PlanMeta"] = []
        self.expr_metas: List[ExprMeta] = []

    def add_expr(self, e: Expression) -> None:
        from .overrides import lookup_expr_rule
        self.expr_metas.append(lookup_expr_rule(e, self.conf))

    def tag_for_device(self) -> None:
        if self.rule is None:
            self.will_not_work(
                f"exec {self.plan.name} is not supported on TPU")
            return
        if not self.conf.is_operator_enabled(self.rule.conf_key):
            self.will_not_work(
                f"exec {self.plan.name} is disabled; enable with "
                f"{self.rule.conf_key}=true")
        for name, dt in zip(self.plan.output.names, self.plan.output.types):
            reason = self.rule.sig.support_reason(dt)
            if reason:
                self.will_not_work(f"exec {self.plan.name}: column {name}: "
                                   f"{reason}")
        for e in self.expr_metas:
            e.tag_for_device()
            for r in e.all_reasons:
                self.will_not_work(r)

    def explain_lines(self, indent: int = 0) -> List[str]:
        mark = "*" if self.can_run_on_device else "!"
        line = "  " * indent + f"{mark} {self.plan.name}"
        if not self.can_run_on_device:
            line += " <- " + "; ".join(self._reasons)
        out = [line]
        for c in self.child_metas:
            out.extend(c.explain_lines(indent + 1))
        return out
