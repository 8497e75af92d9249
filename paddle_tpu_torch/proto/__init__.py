"""The ``paddle.proto`` shim (counterpart of ``paddle_tpu/proto``).

Fluid generates protobuf modules (framework_pb2 and the rest) into this
package from paddle/fluid/framework/framework.proto.  The port has no
generated code: the same wire format is ``paddle_tpu_torch.fluid
.proto_compat``, a proto2 codec written by hand, which this package
names ``framework``.
"""

from paddle_tpu_torch.fluid import proto_compat as framework  # noqa: F401

__all__ = ["framework"]
