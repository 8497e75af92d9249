"""Long-tail NN op lowerings (counterpart of
``paddle_tpu/ops/nn_extra_ops.py``).  Ported so far:
``add_position_encoding``, which the Transformer NMT model's embeddings
run; its grad is derived by the registry (alpha times the output
grad)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op

from .common import rounded


def position_encoding(t, d, device):
    """The [t, d] sinusoid table, fp32: position p times the
    frequencies 10000^(-i/half), i < half = d // 2, their sines in the
    first half of the columns and their cosines in the second
    (concatenated, not interleaved); an odd D's last column is 0."""
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    freq = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                            device=device) / max(half, 1))
    angles = pos * freq[None, :]
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=1)
    if enc.shape[1] < d:
        enc = torch.nn.functional.pad(enc, (0, d - enc.shape[1]))
    return enc


@simple_op("add_position_encoding", ["X"], ["Out"])
def _add_position_encoding(ctx, x, attrs):
    """alpha·x + beta·enc over x [B, T, D], in x's dtype: the table is
    cast to x's dtype first (a bf16 x adds the bf16-rounded table), and
    alpha and beta are rounded to it, as the JAX lowering's weakly
    typed scalars are."""
    _, t, d = x.shape
    enc = position_encoding(t, d, x.device).to(x.dtype)
    alpha = rounded(attrs.get("alpha", 1.0), x.dtype)
    beta = rounded(attrs.get("beta", 1.0), x.dtype)
    return (alpha * x + beta * enc[None, :, :]).to(x.dtype)
