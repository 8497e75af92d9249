"""paddle_tpu_torch.distributed — the port's counterpart of the parts of
``paddle_tpu/distributed`` the serving fleet needs: ``resilience`` (the
retry policy and the resilience counters), ``fault_injection`` (the
FaultPlan grammar and its hooks) and the drain half of ``elastic`` (the
SIGTERM drain handler).  The PS runtime, membership epochs and the
recovery harness are still to be ported."""

from . import elastic, fault_injection, resilience  # noqa: F401
