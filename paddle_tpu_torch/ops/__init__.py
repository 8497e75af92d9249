"""Op lowerings: importing this package registers every ported op."""

from . import (amp_ops, collective_ops, compat_ops,  # noqa: F401
               control_flow_ops, decode_ops, detection_extra_ops,
               detection_ops, fused_ops, health_ops,
               interop_tail_ops, math_ops, metric_ops, nn_extra_ops,
               nn_ops, optimizer_ops, quant_ops, rnn_ops, sequence_ops,
               structured_ops, tensor_array_ops, tensor_ops)
