"""Serving (counterpart of ``paddle_tpu/serving``).  Ported so far: the
paged-KV GPT decode lane (fp32 or dual-int8 pool) and the multi-model
``Engine`` over saved inference models, with its ragged mode.  The
router, frontend, promotion and drill modules are still to be
ported."""

from .batching import BucketPolicy  # noqa: F401
from .decode import DecodeEngine, DecodeRequest  # noqa: F401
from .engine import Engine, model_signature  # noqa: F401
from .errors import (FeedValidationError,  # noqa: F401
                     ModelNotLoadedError, PoolExhaustedError,
                     ServingDeadlineError, ServingError,
                     ServingOverloadError)
from .kv_pool import KVPool  # noqa: F401
