"""``coalesce_tensor`` (counterpart of
``paddle_tpu/ops/interop_tail_ops.py`` :44-74; the rest of that file is
not ported yet)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op


@simple_op("coalesce_tensor", ["Input*"], ["Output*", "FusedOutput"],
           grad=None)
def _coalesce_tensor(ctx, xs, attrs):
    """Pack tensors into one flat buffer: the data-parallel lane's
    gradient bucket.  ``align`` > 1 zero-pads each member to that
    element multiple first, so a member of a fused-update bucket fills
    whole quantization blocks.  The outputs are the inputs themselves;
    ``set_constant`` fills both with ``constant``."""
    align = int(attrs.get("align", 1) or 1)
    flat = []
    for x in xs:
        f = x.reshape(-1)
        pad = (-f.numel()) % align if align > 1 else 0
        flat.append(torch.nn.functional.pad(f, (0, pad)) if pad else f)
    fused = (torch.cat(flat) if flat
             else torch.zeros((0,), dtype=torch.float32, device=ctx.device))
    if attrs.get("set_constant", False):
        c = attrs.get("constant", 0.0)
        return (tuple(torch.full_like(x, c) for x in xs),
                torch.full_like(fused, c))
    return tuple(xs), fused
