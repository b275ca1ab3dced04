"""Helpers for the tests that hold spark_rapids_tpu_torch against the JAX
engine: move a JAX batch's padded buffers into the port unchanged, feed
fixed batches to either engine's execs, and compare Arrow results."""

import numpy as np
import pyarrow as pa

from spark_rapids_tpu.columnar import batch_to_arrow as jax_batch_to_arrow
from spark_rapids_tpu.exec.base import TpuExec as JaxExec
from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
from spark_rapids_tpu_torch.exec.base import TpuExec as PortExec
from spark_rapids_tpu_torch.interop import batch_from_numpy


def port_batch(jb, device="cpu"):
    """The identical padded batch in the port: same capacity, padding
    contents and masks (a string column's byte matrix and lengths, and a
    long-string column's blob and tail offsets)."""
    fields = [(n, t.simple_string())
              for n, t in zip(jb.schema.names, jb.schema.types)]
    datas = [np.asarray(c.data) if c.lengths is None else
             (np.asarray(c.data), np.asarray(c.lengths)) +
             (() if c.overflow is None else
              tuple(np.asarray(a) for a in c.overflow))
             for c in jb.columns]
    return batch_from_numpy(fields, datas,
                            [np.asarray(c.validity) for c in jb.columns],
                            int(jb.num_rows), device)


class JaxSource(JaxExec):
    """A JAX exec that yields fixed batches."""

    def __init__(self, batches):
        super().__init__([])
        self.batches = list(batches)

    @property
    def output(self):
        return self.batches[0].schema

    def do_execute(self):
        yield from self.batches


class PortSource(PortExec):
    """A port exec that yields fixed batches."""

    def __init__(self, batches):
        super().__init__([], device=batches[0].device)
        self.batches = list(batches)

    @property
    def output(self):
        return self.batches[0].schema

    def do_execute(self):
        yield from self.batches


def positional(t: pa.Table, ordered: bool = True) -> pa.Table:
    """Columns renamed c0..cN (joins repeat names), rows sorted unless
    `ordered`: join output order follows how ties sort."""
    t = t.rename_columns([f"c{i}" for i in range(t.num_columns)])
    if ordered or t.num_rows == 0:
        return t
    return t.sort_by([(n, "ascending") for n in t.column_names])


def assert_same_rows(jax_batches, port_batches, ordered: bool = True):
    """Exact equality of the live rows of two batch streams, via Arrow."""
    def table(batches, to_arrow):
        tabs = [to_arrow(b) for b in batches]
        return pa.concat_tables(tabs) if tabs else None

    a = table(jax_batches, jax_batch_to_arrow)
    b = table(port_batches, batch_to_arrow)
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    a, b = positional(a, ordered), positional(b, ordered)
    assert a.schema == b.schema, (a.schema, b.schema)
    assert a.num_rows == b.num_rows, (a.num_rows, b.num_rows)
    for name in a.column_names:
        ca, cb = a.column(name), b.column(name)
        nulls = ca.is_null().to_numpy(zero_copy_only=False)
        assert (nulls == cb.is_null().to_numpy(zero_copy_only=False)).all(), \
            name
        va = ca.to_numpy(zero_copy_only=False)[~nulls]
        vb = cb.to_numpy(zero_copy_only=False)[~nulls]
        # NaN equals NaN here, as in Spark's grouping and join semantics
        assert np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), \
            f"column {name} differs:\nJAX:  {va}\nport: {vb}"
