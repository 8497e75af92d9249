"""Op lowerings: importing this package registers every ported op."""

from . import (decode_ops, fused_ops, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, tensor_ops)
