"""Transpile adapters (counterpart of ``paddle_tpu/passes/adapters.py``):
the program rewriters that are not fusions, registered as passes so
their order against the fusion passes is declared in one place
(framework.PASS_ORDER).

Thin adapters: the data-parallel runner keeps calling the transpile
directly (it needs constructor arguments the pass interface does not
carry).  What registration buys: the registry lists every sanctioned
program rewriter, and ``PassManager`` enforces the relative order when a
pipeline names them.

- ``data_parallel_transpile``: parallel.data_parallel.
  transpile_data_parallel, with the fused dequant→update rewrite,
  ordered after the fusions: its bucket and fused-update scans must see
  the final forward graph.
- ``health_sentinel``: health.transpile.insert_health_sentinel, last:
  its check must read the gradients the optimizer ops finally consume.
  The single-device executor attaches the sentinel itself under
  FLAGS_health_sentinel (health.attach).
"""

from __future__ import annotations

from .framework import ProgramPass, register_program_pass


@register_program_pass
class DataParallelTranspilePass(ProgramPass):
    """Adapter over transpile_data_parallel.  Pipeline use needs
    ``loss_name`` on the ctx; ``num_devices`` (ctx.extra) defaults to the
    number of CUDA cards.  Idempotent via the transpile's summary
    attr."""

    name = "data_parallel_transpile"

    def apply(self, program, ctx):
        if getattr(program, "_collective_bytes_per_step", None) is not None:
            return {"changed": False, "sites": 0}
        import torch

        from paddle_tpu_torch.parallel.data_parallel import (
            transpile_data_parallel)

        if ctx.loss_name is None:
            raise ValueError("data_parallel_transpile needs ctx.loss_name")
        n = ctx.extra.get("num_devices") or torch.cuda.device_count()
        if not n:
            raise ValueError("data_parallel_transpile: no CUDA card; pass "
                             "num_devices in the PassContext")
        transpile_data_parallel(
            program, ctx.loss_name, n,
            quant_grads=bool(ctx.extra.get("quant_grads", False)))
        plan = getattr(program, "_quant_allreduce_plan", None) or {}
        return {"changed": True,
                "sites": len(plan.get("buckets", [])),
                "fused_update_sites": sum(
                    1 for b in plan.get("buckets", [])
                    if b.get("fused_update"))}


@register_program_pass
class HealthSentinelPass(ProgramPass):
    """Adapter over health.transpile.insert_health_sentinel (idempotent
    through ``program._health_plan``)."""

    name = "health_sentinel"

    def apply(self, program, ctx):
        from paddle_tpu_torch.health import insert_health_sentinel

        before = getattr(program, "_health_plan", None)
        plan = insert_health_sentinel(program, loss_name=ctx.loss_name)
        return {"changed": plan is not None and before is None,
                "sites": 1 if plan else 0}
