"""The training health sentinel (counterpart of ``paddle_tpu/health``).

A NaN or Inf gradient, an Inf loss or a loss spike would otherwise
poison the parameters (or, under FLAGS_check_nan_inf, stop the run).
The package:

- ``detect``    the on-device finite check (one scalar a step) and
                FLAGS_check_nan_inf's host scan;
- ``transpile`` ``insert_health_sentinel(program)``: the check before
                the optimizer ops, the bad-step count, dynamic loss
                scaling, and the planted faults of the FaultPlan grammar;
- ``gating``    the executor's in-step skip: a bad step's state writes
                are reverted on the device;
- ``sentinel``  the host's response, raise | skip | rollback, the
                loss-spike detector and the ``pt_health_*`` metrics.

Arm it with ``fluid.set_flags({"FLAGS_health_sentinel": True})``: the
single-device ``Executor`` attaches it to each program it runs, in
``run`` and ``run_steps``, captured or eager.  The data-parallel runner
raises under it (its check would read the fused buckets' QScale).  Not
ported: ``persist`` (the durable rollback window, which comes with
``fluid/incubate/checkpoint``).
"""

from __future__ import annotations

from . import detect  # noqa: F401
from .gating import wrap_body  # noqa: F401
from .sentinel import HealthSentinel, attach, run_guarded  # noqa: F401
from .transpile import (FOUND_INF_VAR, LOSS_SCALE_VAR,  # noqa: F401
                        insert_health_sentinel)

__all__ = [
    "attach",
    "run_guarded",
    "HealthSentinel",
    "insert_health_sentinel",
    "wrap_body",
    "detect",
    "FOUND_INF_VAR",
    "LOSS_SCALE_VAR",
]
