"""Calendar helpers of the date casts (`spark_rapids_tpu/expr/datetime_.py`
`civil_from_days` and the later of its two `days_from_civil`, the one the
JAX module binds): Howard Hinnant's proleptic-Gregorian conversions over
int tensors, with floor division as numpy's `//`. The date and time
expressions of that module are a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["civil_from_days", "days_from_civil"]


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month [1-12], day [1-31]), int32."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                    # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                              # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                  # [1, 12]
    year = y + (m <= 2).to(torch.int64)
    return year.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """(year, month, day) -> days since the epoch, int64 (the inverse of
    civil_from_days)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468
