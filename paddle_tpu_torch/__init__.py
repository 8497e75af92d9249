"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid programming model (Program → passes → Executor → op
lowerings → kernels) on one NVIDIA H100.  Every TPU (Pallas) kernel on
a ported path is a hand-written CUDA kernel for Hopper (``csrc/``),
built with nvcc on first use.  The package imports torch and numpy,
never jax and nothing of ``paddle_tpu``.
"""

from . import fluid  # noqa: F401
