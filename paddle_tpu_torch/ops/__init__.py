"""Op lowerings: importing this package registers every ported op."""

from . import (collective_ops, compat_ops, decode_ops,  # noqa: F401
               fused_ops, interop_tail_ops, math_ops, nn_extra_ops, nn_ops,
               optimizer_ops, quant_ops, rnn_ops, sequence_ops,
               structured_ops, tensor_ops)
