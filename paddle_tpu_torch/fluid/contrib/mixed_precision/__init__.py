"""Mixed precision (counterpart of
``paddle_tpu/fluid/contrib/mixed_precision``): the cast-inserting AMP
``decorate`` with its op lists and program rewrite, and the bf16 dtype
policy (``enable_bf16_policy``), which casts at the lowering instead."""

from .bf16_policy import enable_bf16_policy  # noqa: F401
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import rewrite_program  # noqa: F401

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists", "rewrite_program",
           "enable_bf16_policy"]
