"""Attention primitives (counterpart of
``paddle_tpu/kernels/primitives``).  Ported so far: K1-K3, flash
attention forward and backward, and K5, paged attention over an fp32
pool."""

from .flash import flash_attention  # noqa: F401
from .paged import (NEG_INF, paged_attention,  # noqa: F401
                    paged_attention_reference)
