"""Layer functions (counterpart of ``paddle_tpu/fluid/layers``)."""

from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import create_parameter  # noqa: F401

__all__ = ["data", "create_parameter"] + list(_nn_all)
