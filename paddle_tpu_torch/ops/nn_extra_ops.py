"""Long-tail NN op lowerings (counterpart of
``paddle_tpu/ops/nn_extra_ops.py``).  Ported so far:
``add_position_encoding``, which the Transformer NMT model's embeddings
run, and ``sigmoid_focal_loss``, RetinaNet's classification loss; their
grads are derived by the registry."""

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


@simple_op("sigmoid_focal_loss", ["X", "Label", "FgNum"], ["Out"],
           no_grad_inputs=("Label", "FgNum"))
def _sigmoid_focal_loss(ctx, x, label, fg_num, attrs):
    """Per-class sigmoid focal loss (sigmoid_focal_loss_op.cc).
    x: [N, C] logits; label: [N, 1] in [0, C] (0 = background, class k
    is column k - 1); rows labelled -1 are ignored.  Divided by the
    foreground count, at least 1."""
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    n, c = x.shape
    lbl = label.reshape(-1).to(torch.int32)
    tgt = (lbl[:, None] == (torch.arange(c, device=x.device)[None, :] + 1)
           ).to(x.dtype)
    p = torch.sigmoid(x)
    logsig = torch.nn.functional.logsigmoid
    ce = tgt * (-logsig(x)) + (1 - tgt) * (-logsig(-x))
    pt = tgt * p + (1 - tgt) * (1 - p)
    at = tgt * alpha + (1 - tgt) * (1 - alpha)
    fg = torch.clamp(fg_num.reshape(()).to(x.dtype), min=1.0)
    valid = (lbl != -1).to(x.dtype)[:, None]
    return valid * at * torch.pow(1 - pt, gamma) * ce / fg
