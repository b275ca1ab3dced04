from .device_manager import DeviceManager  # noqa: F401
from .semaphore import TpuSemaphore  # noqa: F401
from .budget import MemoryBudget  # noqa: F401
from .catalog import BufferCatalog, SpillPriority, StorageTier  # noqa: F401
from .spillable import SpillableColumnarBatch  # noqa: F401
from .retry import (split_batch_halves, with_retry,  # noqa: F401
                    with_retry_no_split)
