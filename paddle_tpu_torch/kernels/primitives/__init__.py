"""Attention primitives (counterpart of
``paddle_tpu/kernels/primitives``).  Ported so far: K5, paged attention
over an fp32 pool."""

from .paged import (NEG_INF, paged_attention,  # noqa: F401
                    paged_attention_reference)
