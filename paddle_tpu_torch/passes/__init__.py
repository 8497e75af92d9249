"""paddle_tpu_torch.passes — the graph-optimization pass layer
(counterpart of ``paddle_tpu/passes``).

- ``framework``         — Pass base class, ordered PassManager, selection
                          (FLAGS_graph_passes), idempotence self-check,
                          ``program._pass_report``.
- ``fuse_attention``    — the matmul→[bias]→softmax→[dropout]→matmul
                          attention chain rewritten to ``flash_attention``
                          (K1; K2/K3 in its grad).
- ``fuse_bias_act``     — the FFN elementwise_add→gelu→[dropout] chain
                          rewritten to ``fused_bias_act_dropout`` (K4).
- ``fuse_softmax_xent`` — the softmax→cross_entropy pair rewritten to
                          the bit-exact ``fused_softmax_cross_entropy``.
- ``int8_weights``      — opt-in: fp32 matmul weights stored dual-int8 at
                          rest, rebuilt by ``dequantize_weight_storage``.
- ``adapters``          — the data-parallel transpile (and the health
                          sentinel's slot) registered as passes, so the
                          order lives in one place (PASS_ORDER).
"""

from __future__ import annotations

from . import adapters  # noqa: F401  (registers the transpile adapters)
from . import fuse_attention  # noqa: F401  (registers fuse_attention)
from . import fuse_bias_act  # noqa: F401  (registers fuse_bias_act_dropout)
from . import fuse_softmax_xent  # noqa: F401  (fuse_softmax_cross_entropy)
from . import int8_weights  # noqa: F401  (registers int8_weight_storage)
from .framework import (DEFAULT_PASSES, PASS_ORDER,  # noqa: F401
                        PassContext, PassManager, ProgramPass,
                        apply_graph_passes, get_program_pass,
                        list_program_passes, op_inventory,
                        register_program_pass, resolve_passes)
