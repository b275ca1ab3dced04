"""spark_rapids_tpu_torch: the engine of `spark_rapids_tpu` ported to
PyTorch and hand-written CUDA kernels for NVIDIA Hopper.

It imports torch, numpy and pyarrow, never jax and never the JAX package.
Entry points run on the card (cuda:0) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from . import types  # noqa: F401
from .config import TpuConf, get_default_conf  # noqa: F401
