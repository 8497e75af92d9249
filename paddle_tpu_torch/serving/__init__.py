"""Serving (counterpart of ``paddle_tpu/serving``).  Ported: the
paged-KV GPT decode lane (fp32 or dual-int8 pool), the multi-model
``Engine`` over saved inference models with its ragged mode, the
``/servez`` page (``status``), the multi-replica ``Router`` (breaker,
retry, hedging, decode failover), the HTTP ``Frontend`` and the
failover and hedge drills.  ``promote`` (canary weight promotion) and
its drill are still to be ported."""

from . import batching, decode, drill, engine, errors  # noqa: F401
from . import frontend, kv_pool, router, status  # noqa: F401
from .batching import BucketPolicy  # noqa: F401
from .decode import DecodeEngine, DecodeRequest  # noqa: F401
from .engine import Engine, model_signature  # noqa: F401
from .errors import (FeedValidationError,  # noqa: F401
                     ModelNotLoadedError, PoolExhaustedError,
                     ServingDeadlineError, ServingError,
                     ServingOverloadError)
from .frontend import Frontend  # noqa: F401
from .kv_pool import KVPool  # noqa: F401
from .router import (CircuitBreaker, Replica, Router,  # noqa: F401
                     routerz_payload)
from .status import servez_payload  # noqa: F401
