"""Contrib modules (counterpart of ``paddle_tpu/fluid/contrib``).
Ported so far: the bf16 dtype policy."""

from . import mixed_precision  # noqa: F401,E402
