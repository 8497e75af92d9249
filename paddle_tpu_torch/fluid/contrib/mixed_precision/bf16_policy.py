"""The bf16 dtype policy (counterpart of
``paddle_tpu/fluid/contrib/mixed_precision/bf16_policy.py``).

The policy is program state, not a program rewrite: the executor casts
each op's inputs at the lowering (``executor._apply_bf16_policy``), so
forward and backward compute runs in bfloat16 while the parameters in
the scope stay fp32 masters, the optimizer ops see fp32, and a short
list of loss ops computes in fp32.
"""

from __future__ import annotations

from ...framework import default_main_program

__all__ = ["enable_bf16_policy"]


def enable_bf16_policy(program=None):
    """Run this program's compute in bfloat16 (fp32 master weights)."""
    program = program if program is not None else default_main_program()
    program._dtype_policy = "bf16"
    program._bump_version()
    return program
