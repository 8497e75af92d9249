"""Serving (counterpart of ``paddle_tpu/serving``).  Ported so far: the
paged-KV GPT decode lane."""

from .decode import DecodeEngine, DecodeRequest  # noqa: F401
from .errors import (PoolExhaustedError, ServingError,  # noqa: F401
                     ServingOverloadError)
from .kv_pool import KVPool  # noqa: F401
