"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid programming model (Program → passes → Executor → op
lowerings → kernels) on one NVIDIA H100.  Every TPU (Pallas) kernel on
a ported path is a hand-written CUDA kernel for Hopper (``csrc/``),
built with nvcc on first use.  The package imports torch and numpy,
never jax and nothing of ``paddle_tpu``.

``reader`` and ``dataset`` are the top-level data API of the book
programs (``paddle.batch(paddle.dataset.imdb.train(), 128)``); they
import numpy and the standard library only.
"""

from . import fluid  # noqa: F401
from . import reader  # noqa: F401
from . import dataset  # noqa: F401
from .reader import batch  # noqa: F401
