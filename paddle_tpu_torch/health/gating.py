"""The in-step skip (counterpart of ``paddle_tpu/health/gating.py``).

``wrap_body`` wraps the executor's op loop (fluid/executor.py
``run_plan``, called as ``body(plan, envs, ctxs, bf16)``) so that when
the step's ``@HEALTH@found_inf`` fires, every persistable the step
writes — parameters, optimizer moments, beta powers, batch-norm
statistics — ends the step bit-identical to its value before it: a true
skip, selected on the device, so a run_steps chain and a captured graph
hold it, and nothing is read on the host.

The JAX package reverts the donated buffers, which still hold the
pre-step values.  Here the optimizer lowerings update the scope's
tensors in place and a captured graph writes its results back into the
scope's storage, so the wrapper keeps the pre-step values itself: before
the loop it clones each persistable the plan writes and reads (one
read and one write of the state), and after it writes
``where(found_inf, old, new)`` back (two reads, one write): into the
scope's own tensor where an op updated it in place, else as the new
value the executor writes back.  A BERT-base step with Adam moves
about 6.6 GB more for it (the 1.3 GB of parameters and moments five
times), and its graph pool holds the 1.3 GB of clones.

Health state (the ``@HEALTH@`` variables: loss scale, good and bad
counts, the bad-step total, fault countdowns) is exempt: a bad step
still halves the scale and advances the counts.  A plan that does not
write the found flag (a fetch of the forward alone pruned the optimizer
ops and the check) runs as it is, as does every plan of a program
without a health plan.
"""

from __future__ import annotations

import torch

__all__ = ["wrap_body"]


def wrap_body(program, body):
    """``body`` with the found_inf state gate; ``body`` itself when the
    program carries no health plan."""
    hplan = getattr(program, "_health_plan", None)
    if not hplan or not hplan.get("gate"):
        return body
    found_var = hplan["found_var"]
    from .transpile import HEALTH_PREFIX

    def gated(plan, envs, ctxs, bf16):
        if found_var not in plan.writes:
            return body(plan, envs, ctxs, bf16)
        names = [n for n in plan.writes if not n.startswith(HEALTH_PREFIX)]
        pre = [{n: env[n] for n in names
                if isinstance(env.get(n), torch.Tensor)} for env in envs]
        with torch.no_grad():
            old = [{n: t.clone() for n, t in p.items()} for p in pre]
        body(plan, envs, ctxs, bf16)
        with torch.no_grad():
            for env, p, o in zip(envs, pre, old):
                found = env[found_var].reshape(()).bool()
                for n, was in o.items():
                    new = env.get(n)
                    if (not isinstance(new, torch.Tensor)
                            or new.shape != was.shape
                            or new.dtype != was.dtype):
                        # not an update of the state in place: reverting
                        # would break the write-back
                        continue
                    if new is p[n]:
                        torch.where(found, was, new, out=new)
                    else:
                        env[n] = torch.where(found, was, new)
    return gated
