"""Op lowerings: importing this package registers every ported op."""

from . import (collective_ops, decode_ops, fused_ops,  # noqa: F401
               interop_tail_ops, math_ops, nn_extra_ops, nn_ops,
               optimizer_ops, quant_ops, tensor_ops)
