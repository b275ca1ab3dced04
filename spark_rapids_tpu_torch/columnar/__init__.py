from .column import Column, from_arrow, to_arrow, torch_dtype  # noqa: F401
from .batch import (Schema, ColumnarBatch, batch_from_arrow,  # noqa: F401
                    batch_to_arrow, empty_batch)
from .padding import row_bucket, LANE  # noqa: F401
