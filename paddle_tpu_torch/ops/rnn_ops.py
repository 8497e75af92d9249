"""Recurrent op lowerings: lstm / gru / lstm_unit / gru_unit (counterpart
of ``paddle_tpu/ops/rnn_ops.py``).

The JAX package runs a recurrence as one ``lax.scan``.  Here it is a
Python loop over the padded time axis, each step a hidden-to-hidden
product (accumulated in fp32, ``mxu_dot``) and a few elementwise ops: a
program of them captures as one CUDA graph with the T steps unrolled in
it, and the eager executor launches the step's kernels T times.  Every
grad is derived by the registry (autograd through the loop).

Layout and semantics, as in the JAX package:
  lstm:  Input [B,T,4D] is x already projected (the layer does the fc),
         chunk order {c~, i, f, o}; the peephole weights ride in
         Bias[4D:7D] (checkI, checkF, checkO); cell clip.
  gru:   Input [B,T,3D], chunks {u, r, c~}; Weight [D,3D] = hidden-hidden
         for u, r, then the candidate weight on (r * h_prev);
         ``origin_mode`` selects h = u*h_prev + (1-u)*c~ (True) or
         (1-u)*h_prev + u*c~ (False, the default).
  Variable length: padded positions give zeros in Hidden/Cell and keep
  the carried state; ``is_reverse`` reverses each row's valid prefix (a
  gather, sequence_ops.py ``reverse_valid``).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op

from .common import act_attr, length_mask, mxu_dot
from .sequence_ops import reverse_valid

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(name):
    return _ACTS[name]


def _steps(x, length):
    """The per-step inputs [B, F] along time and the per-step valid
    masks [B, 1] (None without lengths)."""
    mask = length_mask(length, x.shape[1])
    xs = x.unbind(1)
    if mask is None:
        return xs, [None] * len(xs)
    return xs, [m[:, None] for m in mask.unbind(1)]


@simple_op("lstm", ["Input", "Weight", "Bias", "H0", "C0", "Length"],
           ["Hidden", "Cell"],
           optional=("Bias", "H0", "C0", "Length"), no_grad_inputs=("Length",))
def _lstm(ctx, x, w, bias, h0, c0, length, attrs):
    """x: [B,T,4D] pre-projected input; w: [D,4D] hidden-hidden weight;
    bias: [4D] (or [7D] with peepholes).  Outputs Hidden/Cell [B,T,D]."""
    use_peep = bool(attrs.get("use_peepholes", False))
    is_reverse = bool(attrs.get("is_reverse", False))
    cell_clip = float(attrs.get("cell_clip", 0.0))
    act_gate = _act(attrs.get("gate_activation", "sigmoid"))
    act_state = _act(attrs.get("cell_activation", "tanh"))
    act_node = _act(attrs.get("candidate_activation", "tanh"))

    b, _, d4 = x.shape
    d = d4 // 4
    peep = None
    if bias is not None:
        bias = bias.reshape(-1)
        x = x + bias[None, None, :4 * d].to(x.dtype)
        if use_peep:
            peep = (bias[4 * d:5 * d], bias[5 * d:6 * d], bias[6 * d:7 * d])
    h = (x.new_zeros((b, d)) if h0 is None else h0.to(x.dtype))
    c = (x.new_zeros((b, d)) if c0 is None else c0.to(x.dtype))
    if is_reverse:
        x = reverse_valid(x, length)
    hs, cs = [], []
    for xt, valid in zip(*_steps(x, length)):
        g_c, g_i, g_f, g_o = (xt + mxu_dot(h, w)).chunk(4, dim=-1)
        cand = act_node(g_c)
        if peep is None:
            i, f = act_gate(g_i), act_gate(g_f)
        else:
            i = act_gate(g_i + c * peep[0])
            f = act_gate(g_f + c * peep[1])
        c_new = cand * i + c * f
        if cell_clip > 0.0:
            c_new = torch.clamp(c_new, -cell_clip, cell_clip)
        o = act_gate(g_o if peep is None else g_o + c_new * peep[2])
        h_new = o * act_state(c_new)
        if valid is None:
            h, c = h_new, c_new
            hs.append(h)
            cs.append(c)
        else:
            h = torch.where(valid, h_new, h)
            c = torch.where(valid, c_new, c)
            hs.append(torch.where(valid, h_new, 0.0).to(x.dtype))
            cs.append(torch.where(valid, c_new, 0.0).to(x.dtype))
    hidden, cell = torch.stack(hs, dim=1), torch.stack(cs, dim=1)
    if is_reverse:
        hidden = reverse_valid(hidden, length)
        cell = reverse_valid(cell, length)
    return hidden, cell


@simple_op("gru", ["Input", "Weight", "Bias", "H0", "Length"], ["Hidden"],
           optional=("Bias", "H0", "Length"), no_grad_inputs=("Length",))
def _gru(ctx, x, w, bias, h0, length, attrs):
    """x: [B,T,3D] pre-projected {u,r,c~}; w: [D,3D] — [:, :2D] drives the
    u/r gates from h_prev, [:, 2D:] the candidate from (r * h_prev)."""
    is_reverse = bool(attrs.get("is_reverse", False))
    origin_mode = bool(attrs.get("origin_mode", False))
    act_gate = _act(act_attr(attrs.get("gate_activation"), "sigmoid"))
    act_node = _act(act_attr(attrs.get("activation"), "tanh"))

    b, _, d3 = x.shape
    d = d3 // 3
    if bias is not None:
        x = x + bias.reshape(1, 1, -1).to(x.dtype)
    w_gate, w_cand = w[:, :2 * d], w[:, 2 * d:]
    h = x.new_zeros((b, d)) if h0 is None else h0.to(x.dtype)
    if is_reverse:
        x = reverse_valid(x, length)
    hs = []
    for xt, valid in zip(*_steps(x, length)):
        g_ur = xt[:, :2 * d] + mxu_dot(h, w_gate)
        u = act_gate(g_ur[:, :d])
        r = act_gate(g_ur[:, d:])
        cand = act_node(xt[:, 2 * d:] + mxu_dot(r * h, w_cand))
        if origin_mode:
            h_new = u * h + (1.0 - u) * cand
        else:
            h_new = (1.0 - u) * h + u * cand
        if valid is None:
            h = h_new
            hs.append(h)
        else:
            h = torch.where(valid, h_new, h)
            hs.append(torch.where(valid, h_new, 0.0).to(x.dtype))
    hidden = torch.stack(hs, dim=1)
    if is_reverse:
        hidden = reverse_valid(hidden, length)
    return hidden


@simple_op("lstm_unit", ["X", "C_prev"], ["C", "H"])
def _lstm_unit(ctx, x, c_prev, attrs):
    """One LSTM step on pre-projected gates: X [B,4D] chunks {i, f, o, j};
    C = C_prev*sigm(f+forget_bias) + sigm(i)*tanh(j); H = sigm(o)*tanh(C)."""
    forget_bias = float(attrs.get("forget_bias", 0.0))
    i, f, o, j = x.chunk(4, dim=-1)
    c = c_prev * torch.sigmoid(f + forget_bias) \
        + torch.sigmoid(i) * torch.tanh(j)
    return c, torch.sigmoid(o) * torch.tanh(c)


@simple_op("gru_unit", ["Input", "HiddenPrev", "Weight", "Bias"],
           ["Gate", "ResetHiddenPrev", "Hidden"], optional=("Bias",))
def _gru_unit(ctx, x, h_prev, w, bias, attrs):
    """One GRU step: Input [B,3D] pre-projected {u,r,c~}, Weight [D,3D] as
    in the gru op.  Returns (gates, r*h_prev, h)."""
    origin_mode = bool(attrs.get("origin_mode", False))
    act_gate = _act(act_attr(attrs.get("gate_activation"), "sigmoid"))
    act_node = _act(act_attr(attrs.get("activation"), "tanh"))
    d = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(1, -1).to(x.dtype)
    g_ur = x[:, :2 * d] + mxu_dot(h_prev, w[:, :2 * d])
    u = act_gate(g_ur[:, :d])
    r = act_gate(g_ur[:, d:])
    r_h = r * h_prev
    cand = act_node(x[:, 2 * d:] + mxu_dot(r_h, w[:, 2 * d:]))
    if origin_mode:
        h = u * h_prev + (1.0 - u) * cand
    else:
        h = (1.0 - u) * h_prev + u * cand
    return torch.cat([u, r, cand], dim=-1), r_h, h
