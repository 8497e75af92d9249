"""paddle_tpu_torch.passes — the graph-optimization pass layer
(counterpart of ``paddle_tpu/passes``).

- ``framework``     — Pass base class, ordered PassManager, selection
                      (FLAGS_graph_passes), ``program._pass_report``.
- ``fuse_bias_act`` — the FFN elementwise_add→gelu→[dropout] chain
                      rewritten to ``fused_bias_act_dropout`` (K4).
"""

from __future__ import annotations

from . import fuse_bias_act  # noqa: F401  (registers fuse_bias_act_dropout)
from .framework import (DEFAULT_PASSES, PASS_ORDER,  # noqa: F401
                        PassContext, PassManager, ProgramPass,
                        apply_graph_passes, get_program_pass,
                        op_inventory, register_program_pass,
                        resolve_passes)
