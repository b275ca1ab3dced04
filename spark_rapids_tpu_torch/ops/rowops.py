"""Row-level device ops shared by the execs (`spark_rapids_tpu/ops/rowops.py`):
stable compaction, gather, multi-key sort, group ids, segmented reduction.

Compaction keeps the padded capacity and returns a new logical count as a
device scalar: a stable sort on the keep flags, no host sync. torch has no
lexsort, so `lexsort_indices` chains stable sorts from the least
significant key up, which gives the same permutation. The JAX package
sorts a string key by one key per byte column; here each 8 bytes pack into
one int64 word, big-endian with the top bit flipped (torch sorts signed
values), which is the same order in an eighth of the sorts. torch's
`index_add_` and `scatter_reduce_` raise on out-of-range indices where JAX
drops them, so `segment_reduce` sends such rows to a spare slot.

A decimal of more than 18 digits (int64[cap, 2] limbs) sorts by two keys,
its signed high limb and its low limb with the sign bit flipped (the
unsigned order in signed space), which is the signed 128-bit order; two
rows are the same key when both limbs are equal.

Floating keys sort with NaN greatest and -0.0 equal to 0.0 (the stable
sort keeps them adjacent, and the key-change test sees them equal); Min
and Max over DOUBLE and FLOAT follow the same order, Spark's: NaN is
greater than +inf and equal to NaN, so a group's max is NaN if it holds
one and its min is NaN only if it holds nothing else. The JAX package
propagates NaN through both.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import types as T
from ..expr.base import Vec, require_flat_strings

__all__ = ["gather_vecs", "compact_vecs", "string_sort_words",
           "sort_keys_for", "lexsort_indices", "sort_batch_vecs",
           "key_change_flags", "group_ids_from_sorted", "segment_sum",
           "segment_reduce"]


def gather_vecs(vecs: Sequence[Vec], idx: torch.Tensor) -> List[Vec]:
    return [v.gather(idx) for v in vecs]


def compact_vecs(vecs: Sequence[Vec],
                 keep_mask: torch.Tensor) -> Tuple[List[Vec], torch.Tensor]:
    """Stable-move rows where keep_mask (bool[cap]) to the front; returns
    (columns, new_count). Padding tail contents are unspecified."""
    order = torch.sort((~keep_mask).to(torch.int8), stable=True).indices
    new_count = keep_mask.sum(dtype=torch.int32)
    return gather_vecs(vecs, order), new_count


def string_sort_words(chars: torch.Tensor) -> List[torch.Tensor]:
    """uint8[n, w] (w a multiple of 8) -> w/8 int64 keys, most significant
    first, whose signed order is the unsigned bytewise order of the rows."""
    n, w = chars.shape
    words = chars.reshape(n, w // 8, 8).flip(-1).contiguous() \
        .view(torch.int64).reshape(n, w // 8)  # big-endian words
    words = words ^ torch.iinfo(torch.int64).min  # flip the top bit
    return list(words.unbind(1))


def sort_keys_for(v: Vec, ascending: bool = True,
                  nulls_first: bool = True) -> List:
    """Sort key tensors for one sort order over a column, MOST significant
    first: [null position, (NaN position), value keys...]. Ascending and
    nulls first is the grouping order.

      * The null key is the validity (null 0 before valid 1) for nulls
        first, its complement for nulls last.
      * A string's value keys are its packed words, then its length (the
        trailing-NUL tie-break of string_compare); descending takes the
        complement of each word and of the length, which reverses their
        signed order (the JAX package's 255 - byte and ~length).
      * Integers, dates, timestamps and decimals of <= 18 digits (the
        int64 unscaled value) sort by their value, descending by its
        complement (no overflow at the type's minimum).
      * A wider decimal sorts by its high limb and its flipped low limb,
        descending by the complement of each.
      * A float sorts NaN greatest (first when descending) and descending
        by its negation. Zeros are made 0.0 after any negation: the
        card's radix sort orders the bit patterns of -0.0 and 0.0 apart,
        and Spark holds them equal (the stable sort keeps their order).
    """
    null_key = v.validity if nulls_first else ~v.validity
    keys: List = [null_key.to(torch.int8)]
    if v.is_string:
        require_flat_strings(v, "sort key over string")
        words = string_sort_words(v.data) + [v.lengths]
        keys.extend(words if ascending else [~w for w in words])
    elif v.data.dim() == 2:  # decimal128 limbs
        from ..expr.decimal128 import cmp_keys
        words = list(cmp_keys(v.data[:, 0], v.data[:, 1]))
        keys.extend(words if ascending else [~w for w in words])
    elif T.is_floating(v.dtype):
        nan = torch.isnan(v.data)
        zero = torch.zeros((), dtype=v.data.dtype, device=v.data.device)
        # NaN sorts greatest: last ascending, first descending
        keys.append((nan if ascending else ~nan).to(torch.int8))
        val = v.data if ascending else -v.data
        keys.append(torch.where(nan | (val == 0), zero, val))
    else:
        data = v.data.to(torch.int8) if v.data.dtype == torch.bool \
            else v.data
        keys.append(data if ascending else ~data)
    return keys


def lexsort_indices(key_groups: Sequence[List]) -> torch.Tensor:
    """Keys given MOST significant first; returns the stable permutation."""
    flat: List = [k for grp in key_groups for k in grp]
    order = None
    for k in reversed(flat):
        kk = k if order is None else k[order]
        idx = torch.sort(kk, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def sort_batch_vecs(vecs: Sequence[Vec], sort_cols: Sequence[int],
                    ascending: Sequence[bool], nulls_first: Sequence[bool],
                    row_mask: torch.Tensor) -> List[Vec]:
    """Sort all columns by the given sort orders; padding rows sort last."""
    groups = [[(~row_mask).to(torch.int8)]]  # padding after everything
    for ci, asc, nf in zip(sort_cols, ascending, nulls_first):
        groups.append(sort_keys_for(vecs[ci], asc, nf))
    return gather_vecs(vecs, lexsort_indices(groups))


def key_change_flags(key_vecs: Sequence[Vec], n: int) -> torch.Tensor:
    """True at rows whose key differs from the previous row (row 0 False).
    Two nulls are equal, and two NaNs are equal (Spark grouping)."""
    device = key_vecs[0].data.device if key_vecs else None
    change = torch.zeros(n, dtype=torch.bool, device=device)
    for v in key_vecs:
        both_valid = v.validity[1:] & v.validity[:-1]
        if v.is_string:  # zero-tailed rows: equal strings, equal bytes
            require_flat_strings(v, "segment boundary over string")
            neq = (v.data[1:] != v.data[:-1]).any(dim=1) | \
                (v.lengths[1:] != v.lengths[:-1])
        elif v.data.dim() == 2:  # decimal128 limbs
            neq = (v.data[1:] != v.data[:-1]).any(dim=1)
        else:
            neq = v.data[1:] != v.data[:-1]
        if v.data.is_floating_point():
            neq = neq & ~(torch.isnan(v.data[1:]) & torch.isnan(v.data[:-1]))
        neq = (neq & both_valid) | (v.validity[1:] != v.validity[:-1])
        change[1:] |= neq
    return change


def group_ids_from_sorted(key_vecs: Sequence[Vec], row_mask: torch.Tensor):
    """After sorting by keys: (group_id[cap], num_groups, starts_mask).
    Rows beyond the live region get id cap-1 (callers mask them)."""
    n = row_mask.shape[0]
    change = key_change_flags(key_vecs, n)
    starts = change | (torch.arange(n, device=row_mask.device) == 0)
    starts = starts & row_mask
    gid = torch.cumsum(starts, dim=0, dtype=torch.int32) - 1
    gid = torch.where(row_mask, gid, n - 1)
    return gid, starts.sum(dtype=torch.int32), starts


def _neutral(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


# Whole-stage fusion hook (exec/fused.py): while a fused stage runs its
# partial aggregate member with the kernels engaged, this holds
# ops.pallas_groupby.fused_segment_sum (exact, and plain outside int64).
# None (always, outside that member) means the plain paths below run.
_FUSED_SEGMENT_SUM = None


def segment_sum(contrib: torch.Tensor, gid: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Plain segmented sum into `cap` groups. Ids are range-checked in their
    own width and rows outside [0, cap) go to a spare slot that is cut off."""
    idx = torch.where((gid >= 0) & (gid < cap), gid, cap).to(torch.int64)
    out = torch.zeros((cap + 1,) + contrib.shape[1:], dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, idx, contrib)[:cap]


def segment_reduce(op: str, data: torch.Tensor, gid: torch.Tensor, cap: int,
                   valid: torch.Tensor = None) -> torch.Tensor:
    """Segmented reduction over rows with group ids; invalid rows are
    excluded (null-skipping aggregates). Returns a per-group tensor of
    length cap. Ids outside [0, cap) contribute nothing. A 2-D `data`
    (rows along dim 0) sums column by column."""
    if valid is None:
        valid = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    if op == "count":
        ones = valid.to(torch.int64)
        if _FUSED_SEGMENT_SUM is not None:
            return _FUSED_SEGMENT_SUM(ones, gid, cap)
        return segment_sum(ones, gid, cap)
    if op == "sum":
        keep = valid if data.dim() == 1 else valid[:, None]
        contrib = torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))
        if _FUSED_SEGMENT_SUM is not None and contrib.dim() == 1:
            return _FUSED_SEGMENT_SUM(contrib, gid, cap)
        return segment_sum(contrib, gid, cap)
    if op in ("min", "max"):
        idx = torch.where((gid >= 0) & (gid < cap), gid, cap).to(torch.int64)
        is_bool = data.dtype == torch.bool
        work = data.to(torch.int32) if is_bool else data
        if not work.is_floating_point():
            out = _scatter_extreme(op, work, idx, valid, cap)
            return out.to(torch.bool) if is_bool else out
        # NaN is the greatest value: reduce with NaN as +inf, then a group
        # is NaN where max met a NaN or min met nothing else
        nan = torch.isnan(work)
        out = _scatter_extreme(op, torch.where(nan, float("inf"), work), idx,
                               valid, cap)
        flag = _scatter_extreme(op, nan.to(torch.int32), idx, valid, cap)
        return torch.where(flag == 1, float("nan"), out)
    raise ValueError(f"unknown segmented op {op}")


def _scatter_extreme(op: str, work: torch.Tensor, idx: torch.Tensor,
                     valid: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group amin/amax of `work` over the valid rows (the neutral value
    where a group has none), ids outside [0, cap) already at cap."""
    neutral = _neutral(op, work.dtype)
    fill = torch.full((), neutral, dtype=work.dtype, device=work.device)
    out = torch.full((cap + 1,), neutral, dtype=work.dtype,
                     device=work.device)
    return out.scatter_reduce_(0, idx, torch.where(valid, work, fill),
                               "amin" if op == "min" else "amax")[:cap]


_U64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _s64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch shifts arithmetically)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def sample_mask(n: int, row_offset, fraction: float, seed: int,
                device) -> torch.Tensor:
    """Bernoulli sample mask over the global row ordinals row_offset + i
    (JAX `ops/rowops.py` `sample_mask`): splitmix64 of the ordinal xor the
    premixed seed, its top 53 bits as a uniform in [0, 1), kept below
    `fraction`. torch has no uint64 arithmetic on CUDA, so the bits ride
    int64, whose multiplication and addition wrap mod 2^64 as uint64's do;
    the seed premix stays in Python ints. `row_offset` is an int or an
    int64 device scalar (no host read). The same bits as the JAX mask, so
    both engines keep the same rows for a seed."""
    idx = torch.arange(n, dtype=torch.int64, device=device) + row_offset
    seed_mix = ((seed & _U64) * _GOLDEN) & _U64
    z = (idx ^ _s64(seed_mix)) + _s64(_GOLDEN)
    z = (z ^ _lsr(z, 30)) * _s64(_MIX1)
    z = (z ^ _lsr(z, 27)) * _s64(_MIX2)
    z = z ^ _lsr(z, 31)
    u = _lsr(z, 11).to(torch.float64) * (2.0 ** -53)
    return u < fraction
