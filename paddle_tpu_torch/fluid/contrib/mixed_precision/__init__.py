"""Mixed precision (counterpart of
``paddle_tpu/fluid/contrib/mixed_precision``).  Ported so far:
``enable_bf16_policy``; the cast-inserting ``decorate`` AMP is not."""

from .bf16_policy import enable_bf16_policy  # noqa: F401

__all__ = ["enable_bf16_policy"]
