"""Layer functions (counterpart of ``paddle_tpu/fluid/layers``)."""

from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all

__all__ = ["data"] + list(_nn_all)
