"""Attention primitives (counterpart of
``paddle_tpu/kernels/primitives``): K1-K3 flash attention forward and
backward, K5 and K7 paged attention over an fp32 and a dual-int8 pool,
K6 ragged attention, and the dual-int8 codec the int8 pool and int8
weights store."""

from .flash import flash_attention  # noqa: F401
from .int8 import (book_bytes_saved, bytes_saved,  # noqa: F401
                   dequantize_lastdim, dequantize_weight, dual_int8_bytes,
                   quantize_lastdim, quantize_weight)
from .paged import (NEG_INF, paged_attention,  # noqa: F401
                    paged_attention_quant, paged_attention_quant_reference,
                    paged_attention_reference)
from .ragged import (ragged_attention,  # noqa: F401
                     ragged_attention_reference)
