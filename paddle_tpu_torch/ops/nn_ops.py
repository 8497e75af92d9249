"""Convolution, pooling, normalization, dropout and attention op
lowerings (counterpart of ``paddle_tpu/ops/nn_ops.py``).

The convs run on the library's convolutions (cuDNN on the card), as the
JAX package leaves them to XLA; their grad ops are written by hand, one
``convolution_backward`` each, since the registry's autograd derivation
would run the forward conv again every step.  ``batch_norm`` has a grad
maker that emits one ``batch_norm_grad`` (closed form).  The grads of
``pool2d``, ``layer_norm``, ``flash_attention``,
``softmax_mask_fuse_upper_triangle``, ``moe_ffn`` and the two
interpolations (``bilinear_interp``, ``nearest_interp``) are derived by
the registry;
``dropout`` has a grad maker that replays its saved mask;
``ragged_attention`` is inference-only."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.fluid.registry import simple_op, wanted_grads
from paddle_tpu_torch.kernels.primitives import flash as _flash
from paddle_tpu_torch.kernels.primitives import ragged as _ragged

from .common import (conv_nd_grad, conv_nd_raw, conv_operands, op_generator,
                     pad_spatial, rounded)

# ---------------------------------------------------------------------------
# convolution: NCHW / OIHW; Paddle's paddings (ops/common.py conv_nd_raw)
# ---------------------------------------------------------------------------

_CONV_SLOTS = (["Input", "Filter", "Bias"], ["Output"])
_CONV_GRAD_SLOTS = (["Input", "Filter", "Bias", "Output@GRAD"],
                    ["Input@GRAD", "Filter@GRAD", "Bias@GRAD"])


def _conv_geometry(attrs, nd):
    return (attrs.get("strides", [1] * nd), attrs.get("paddings", [0] * nd),
            attrs.get("dilations", [1] * nd))


def _add_bias(out, bias):
    if bias is None:
        return out
    return out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))


def _bias_grad(dout, bias, want):
    if bias is None or "Bias@GRAD" not in want:
        return None
    return dout.sum(dim=[0] + list(range(2, dout.dim()))).to(bias.dtype)


def _register_conv(op_type, nd, depthwise=False):
    def groups(x, attrs):
        return x.shape[1] if depthwise else attrs.get("groups", 1)

    def lower(ctx, x, w, bias, attrs):
        return _add_bias(conv_nd_raw(x, w, *_conv_geometry(attrs, nd),
                                     groups(x, attrs), nd), bias)

    def lower_grad(ctx, x, w, bias, dout, attrs):
        want = wanted_grads(ctx, op_type + "_grad", _CONV_GRAD_SLOTS[1])
        dx, dw = conv_nd_grad(x, w, dout, *_conv_geometry(attrs, nd),
                              groups(x, attrs), nd, "Input@GRAD" in want,
                              "Filter@GRAD" in want)
        return dx, dw, _bias_grad(dout, bias, want)

    simple_op(op_type, *_CONV_SLOTS, optional=("Bias",))(lower)
    # differentiable (convolution_backward has a derivative): the
    # second-order conv grads derive from it
    simple_op(op_type + "_grad", *_CONV_GRAD_SLOTS, grad="lazy",
              optional=("Bias", "Output@GRAD"))(lower_grad)


_register_conv("conv2d", 2)
_register_conv("depthwise_conv2d", 2, depthwise=True)  # groups = C
_register_conv("conv3d", 3)


def _transpose_args(attrs):
    """stride, padding, dilation and groups of ``conv2d_transpose``:
    the JAX lowering pads each side by d·(k − 1) − p of the first two
    paddings, which is the library's transposed conv at padding p."""
    return (list(attrs.get("strides", [1, 1])),
            list(attrs.get("paddings", [0, 0]))[:2],
            list(attrs.get("dilations", [1, 1])), attrs.get("groups", 1))


@simple_op("conv2d_transpose", *_CONV_SLOTS, optional=("Bias",))
def _conv2d_transpose(ctx, x, w, bias, attrs):
    """Filter laid out (in, out/groups, kh, kw), as the library's."""
    stride, pad, dil, groups = _transpose_args(attrs)
    xs, ws = conv_operands(x, w)
    out = F.conv_transpose2d(xs, ws, None, stride, pad, 0, groups, dil)
    return _add_bias(out.to(x.dtype), bias)


@simple_op("conv2d_transpose_grad", *_CONV_GRAD_SLOTS, grad="lazy",
           optional=("Bias", "Output@GRAD"))
def _conv2d_transpose_grad(ctx, x, w, bias, dout, attrs):
    want = wanted_grads(ctx, "conv2d_transpose_grad", _CONV_GRAD_SLOTS[1])
    stride, pad, dil, groups = _transpose_args(attrs)
    xs, ws = conv_operands(x, w)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dout.to(xs.dtype), xs, ws, None, stride, pad, dil, True, [0, 0],
        groups, ["Input@GRAD" in want, "Filter@GRAD" in want, False])
    return (None if dx is None else dx.to(x.dtype),
            None if dw is None else dw.to(w.dtype),
            _bias_grad(dout, bias, want))


# ---------------------------------------------------------------------------
# pooling: the JAX lowering's contract (explicit pads, then a pool with
# no padding of its own)
# ---------------------------------------------------------------------------


def _ceil_extra(size, k, s, p):
    """Rows (or columns) ``ceil_mode`` pads past the right edge: enough
    for the last window the ceiling counts, checked no further (a last
    window may start in the padding, which the library's ceil_mode
    drops)."""
    out_floor = (size + 2 * p - k) // s + 1
    out_ceil = math.ceil((size + 2 * p - k) / s) + 1
    return (out_ceil - out_floor) * s


@simple_op("pool2d", ["X"], ["Out"])
def _pool2d(ctx, x, attrs):
    """Max pooling pads with −inf; average pooling sums the window
    (zeros in the padding) and divides by the count inside the input
    only when ``exclusive`` and a padding is nonzero, else by kh·kw.
    ``global_pooling`` (or ``adaptive`` to 1x1) reduces H and W;
    ``adaptive`` splits them into ksize bins, which must divide them."""
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", ksize))
    paddings = list(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False) or attrs.get(
            "adaptive", False) and ksize == [1, 1]:
        if ptype == "max":
            return x.amax(dim=(2, 3), keepdim=True)
        return x.mean(dim=(2, 3), keepdim=True)
    if attrs.get("adaptive", False):
        n, c, h, wd = x.shape
        oh, ow = ksize
        if h % oh or wd % ow:
            raise ValueError(f"pool2d: adaptive pooling to {ksize} needs "
                             f"divisible dims, got {h}x{wd}")
        r = x.reshape(n, c, oh, h // oh, ow, wd // ow)
        return r.amax(dim=(3, 5)) if ptype == "max" else r.mean(dim=(3, 5))
    pads = [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    if attrs.get("ceil_mode", False):
        pads = [(p, p + _ceil_extra(size, k, s, p)) for (p, _), size, k, s
                in zip(pads, x.shape[2:], ksize, strides)]
    if ptype == "max":
        low = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        return F.max_pool2d(pad_spatial(x, pads, low), ksize, strides)
    summed = F.avg_pool2d(pad_spatial(x, pads), ksize, strides,
                          divisor_override=1)
    if attrs.get("exclusive", True) and (paddings[0] or paddings[1]):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return summed / F.avg_pool2d(pad_spatial(ones, pads), ksize,
                                     strides, divisor_override=1)
    return summed / (ksize[0] * ksize[1])


# ---------------------------------------------------------------------------
# batch_norm: statistics in fp32 as E[x²] − E[x]²; SavedVariance is the
# inverse standard deviation; the running statistics are written in place
# ---------------------------------------------------------------------------


def _bn_axes(x, attrs):
    """The reduced axes and the channel axis of ``x`` for the layout."""
    ch = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    return tuple(i for i in range(x.dim()) if i != ch), ch


def _bn_mode(ctx, attrs):
    """True for the training form: is_test (the op's or the run's)
    without trainable_statistics uses the running statistics."""
    return not ((attrs.get("is_test", False) or ctx.is_test)
                and not attrs.get("trainable_statistics", False))


def _bn_stats(xf, axes):
    """Batch mean and biased variance, E[x²] − E[x]², of fp32 ``xf``."""
    mean = xf.mean(dim=axes)
    return mean, (xf * xf).mean(dim=axes) - mean * mean


def _bn_grad_maker(op, out_grads, wanted, uniq):
    """One ``batch_norm_grad`` with inputs X, Scale, Bias, Mean,
    Variance and Y@GRAD: d(Y) -> d(X, Scale, Bias); the running
    statistics' update carries no grad."""
    ins = {k: list(v) for k, v in op.inputs.items()}
    ins["Y@GRAD"] = [out_grads[op.outputs["Y"][0]]]
    outs, pairs = {}, []
    for slot in ("X", "Scale", "Bias"):
        n = op.inputs[slot][0]
        if n in wanted:
            g = uniq(n)
            outs[slot + "@GRAD"] = [g]
            pairs.append((n, g))
    return [("batch_norm_grad", ins, outs, dict(op.attrs))], pairs


@simple_op("batch_norm", ["X", "Scale", "Bias", "Mean", "Variance"],
           ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
           grad="custom", grad_maker=_bn_grad_maker,
           inplace={"MeanOut": "Mean", "VarianceOut": "Variance"})
def _batch_norm(ctx, x, scale, bias, mean, var, attrs):
    """Y in x's dtype, computed in fp32.  Training: the batch
    statistics; the running ones become momentum·old + (1 − momentum)·
    batch (biased variance), written into Mean and Variance in place;
    SavedMean is the batch mean and SavedVariance rsqrt(var + eps).  In
    the is_test form: the running statistics, returned as the outputs
    unchanged."""
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axes, ch = _bn_axes(x, attrs)
    shape = [1] * x.dim()
    shape[ch] = -1
    xf = x.float()
    if not _bn_mode(ctx, attrs):
        inv = torch.rsqrt(var.float() + eps)
        y = ((xf - mean.float().reshape(shape))
             * (inv * scale.float()).reshape(shape)
             + bias.float().reshape(shape))
        return y.to(x.dtype), mean, var, mean, var
    bmean, bvar = _bn_stats(xf, axes)
    inv = torch.rsqrt(bvar + eps)
    y = ((xf - bmean.reshape(shape)) * inv.reshape(shape)
         * scale.float().reshape(shape) + bias.float().reshape(shape))
    mean.copy_(momentum * mean + (1 - momentum) * bmean.to(mean.dtype))
    var.copy_(momentum * var + (1 - momentum) * bvar.to(var.dtype))
    return y.to(x.dtype), mean, var, bmean, inv


@simple_op("batch_norm_grad",
           ["X", "Scale", "Bias", "Mean", "Variance", "Y@GRAD"],
           ["X@GRAD", "Scale@GRAD", "Bias@GRAD"], grad=None,
           optional=("Mean", "Variance"))
def _batch_norm_grad(ctx, x, scale, bias, mean, var, dy, attrs):
    """The closed form of the normalization's grads in fp32, the batch
    statistics computed again as the forward computed them: with x̂ the
    normalized input, dBias = Σ dy, dScale = Σ dy·x̂ and dX = scale·inv·
    (dy − dBias/N − x̂·dScale/N); in the is_test form dX = dy·scale·inv
    of the running variance."""
    eps = attrs.get("epsilon", 1e-5)
    axes, ch = _bn_axes(x, attrs)
    shape = [1] * x.dim()
    shape[ch] = -1
    xf, g = x.float(), dy.float()
    train = _bn_mode(ctx, attrs)
    if train:
        bmean, bvar = _bn_stats(xf, axes)
    else:
        bmean, bvar = mean.float(), var.float()
    inv = torch.rsqrt(bvar + eps)
    xhat = (xf - bmean.reshape(shape)) * inv.reshape(shape)
    dbias = g.sum(dim=axes)
    dscale = (g * xhat).sum(dim=axes)
    k = (scale.float() * inv).reshape(shape)
    if train:
        n = xf.numel() // xf.shape[ch]
        dx = k * (g - (dbias / n).reshape(shape)
                  - xhat * (dscale / n).reshape(shape))
    else:
        dx = k * g
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype)


@simple_op("layer_norm", ["X", "Scale", "Bias"], ["Y", "Mean", "Variance"],
           optional=("Scale", "Bias"))
def _layer_norm(ctx, x, scale, bias, attrs):
    """Normalize over dims [begin_norm_axis, rank) in fp32; Mean and
    Variance come back shaped x.shape[:begin_norm_axis]."""
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    norm_shape = tuple(x.shape[begin:])
    w = scale.float().reshape(norm_shape) if scale is not None else None
    b = bias.float().reshape(norm_shape) if bias is not None else None
    y, mean, rstd = torch.native_layer_norm(x.float(), norm_shape, w, b,
                                            eps)
    lead = tuple(x.shape[:begin])
    var = rstd.reshape(lead).pow(-2) - eps
    return y.to(x.dtype), mean.reshape(lead), var


# ---------------------------------------------------------------------------
# dropout: the grad op multiplies by the saved mask, so forward and
# backward agree exactly
# ---------------------------------------------------------------------------


def _dropout_grad_maker(op, out_grads, wanted, uniq):
    x = op.inputs["X"][0]
    if x not in wanted:
        return [], []
    g = uniq(x)
    ins = {"Out@GRAD": [out_grads[op.outputs["Out"][0]]],
           "Mask": list(op.outputs["Mask"])}
    return [("dropout_grad", ins, {"X@GRAD": [g]}, dict(op.attrs))], [(x, g)]


def _upscale(attrs):
    return 1.0 / max(1.0 - attrs.get("dropout_prob", 0.5), 1e-8)


@simple_op("dropout", ["X"], ["Out", "Mask"], grad="custom",
           grad_maker=_dropout_grad_maker)
def _dropout(ctx, x, attrs):
    """The uint8 keep-mask is drawn from the run's generator (or the op's
    own, for a nonzero ``seed``) and returned as Mask."""
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        ones = torch.ones(x.shape, dtype=torch.uint8, device=x.device)
        if impl == "upscale_in_train":
            return x, ones
        return x * rounded(1.0 - p, x.dtype), ones
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.device.type != "meta":
        mask.bernoulli_(1.0 - p, generator=op_generator(ctx, attrs))
    out = x * mask.to(x.dtype)
    if impl == "upscale_in_train":
        out = out * rounded(_upscale(attrs), x.dtype)
    return out, mask


@simple_op("dropout_grad", ["Out@GRAD", "Mask"], ["X@GRAD"], grad=None)
def _dropout_grad(ctx, dy, mask, attrs):
    m = mask.to(dy.dtype)
    if attrs.get("dropout_implementation",
                 "downgrade_in_infer") == "upscale_in_train":
        m = m * rounded(_upscale(attrs), dy.dtype)
    return dy * m


@simple_op("softmax_mask_fuse_upper_triangle", ["X"], ["Out"])
def _causal_softmax(ctx, x, attrs):
    """Causal softmax over the last axis of [..., S, S] scores: the
    future positions (above the diagonal) are filled with -1e9, as the
    JAX op fills them, and the softmax runs in x's dtype."""
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(keep, x, rounded(-1e9, x.dtype)),
                         dim=-1)


@simple_op("flash_attention", ["Q", "K", "V", "Bias"], ["Out"],
           optional=("Bias",))
def _flash_attention(ctx, q, k, v, bias, attrs):
    """Attention over [B, n_heads, S, d] through K1 (forward) and, when
    differentiated, K2/K3.  The JAX op's ring-attention branch
    (``sequence_parallel`` under an 'sp' mesh) is not ported: on one
    device the JAX op runs this same kernel."""
    return _flash.flash_attention(q, k, v, bias=bias,
                                  causal=attrs.get("causal", False),
                                  sm_scale=attrs.get("sm_scale"),
                                  force=attrs.get("force"))


@simple_op("moe_ffn", ["X", "GateW", "W1", "B1", "W2", "B2"], ["Out"],
           optional=("B1", "B2"))
def _moe_ffn(ctx, x, gate_w, w1, b1, w2, b2, attrs):
    """Mixture-of-experts FFN with top-k gating, dense dispatch: every
    expert runs over every token and the kept gate probabilities
    combine them (the JAX op's formulation, built for an expert dim
    sharded over an 'ep' mesh axis).

    x [B, S, D]; gate_w [D, E]; w1 [E, D, H]; b1 [E, H]; w2 [E, H, D];
    b2 [E, D].  The gate logits accumulate in fp32 and the softmax runs
    there.  With top_k < E the mask is ``probs >= kth``, kth the k-th
    largest probability (so a tie keeps more than k experts), and the
    kept probabilities are renormalized and cast to the experts'
    dtype.  ``act`` is "gelu" (``jax.nn.gelu``'s default: the tanh
    form) or "relu"."""
    from paddle_tpu_torch.kernels.fused_bias_act import gelu_reference

    top_k = int(attrs.get("top_k", 2))
    e = w1.shape[0]
    logits = torch.einsum("bsd,de->bse", x.float(), gate_w.float())
    probs = torch.softmax(logits, dim=-1)
    if top_k < e:
        kth = torch.topk(probs, top_k, dim=-1).values[..., -1:]
        probs = torch.where(probs >= kth, probs, 0.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    h = torch.einsum("bsd,edh->ebsh", x, w1.to(x.dtype))
    if b1 is not None:
        h = h + b1[:, None, None, :].to(h.dtype)
    h = (gelu_reference(h, approximate=True)
         if attrs.get("act", "gelu") == "gelu" else torch.relu(h))
    y = torch.einsum("ebsh,ehd->ebsd", h, w2.to(h.dtype))
    if b2 is not None:
        y = y + b2[:, None, None, :].to(y.dtype)
    out = torch.einsum("ebsd,bse->bsd", y, probs.to(y.dtype))
    return out.to(x.dtype)


@simple_op("ragged_attention", ["Q", "K", "V", "Lengths"], ["Out"],
           grad=None)
def _ragged_attention(ctx, q, k, v, lengths, attrs):
    """Variable-length attention driven by a per-row length vector (K6):
    row b attends keys j < lengths[b].  q, k and v arrive as the
    transpose2 views the serving model makes; the kernel reads them in
    place."""
    return _ragged.ragged_attention(
        q, k, v, lengths.int().contiguous(),
        causal=attrs.get("causal", False), sm_scale=attrs.get("sm_scale"),
        force=attrs.get("force"))


# ---------------------------------------------------------------------------
# interpolation (interpolate_op.h): bilinear_interp and nearest_interp, the
# upsampling of YOLOv3's and FPN's heads; grads derived by the registry
# ---------------------------------------------------------------------------


def _interp_out_hw(attrs, h, w, out_size):
    """The out_h/out_w attrs, else the ``scale`` attr (used when out_h
    <= 0).  The reference's OutSize tensor input is a run-time shape,
    which a static-shape program cannot honour: it raises by name."""
    if out_size is not None:
        raise NotImplementedError(
            "interp ops: the OutSize tensor input is a run-time shape "
            "override a static-shape program cannot honor; set static "
            "out_h/out_w (or scale) attrs instead")
    oh, ow = attrs.get("out_h"), attrs.get("out_w")
    scale = float(attrs.get("scale", 0.0) or 0.0)
    if (not oh or oh <= 0) and scale > 0:
        oh = int(h * scale)
    if (not ow or ow <= 0) and scale > 0:
        ow = int(w * scale)
    if not oh or not ow or oh <= 0 or ow <= 0:
        raise ValueError(
            "interp ops need a static output size: set out_h/out_w > 0 "
            f"or scale > 0 (got out_h={attrs.get('out_h')!r}, "
            f"out_w={attrs.get('out_w')!r}, scale={scale!r})")
    return int(oh), int(ow)


def _interp_src_coords(out_len, in_len, align_corners, align_mode, device):
    """Source coordinates (interpolate_op.h): align_corners → ratio
    (in-1)/(out-1), src = ratio·dst; else ratio in/out with align_mode
    0 half-pixel (max(ratio·(dst+½)−½, 0)) and mode 1 src = ratio·dst."""
    d = torch.arange(out_len, dtype=torch.float32, device=device)
    if align_corners:
        return d * ((in_len - 1) / max(out_len - 1, 1))
    ratio = in_len / out_len
    if int(align_mode) == 0:
        return torch.clamp(ratio * (d + 0.5) - 0.5, min=0.0)
    return ratio * d


@simple_op("bilinear_interp", ["X", "OutSize"], ["Out"],
           optional=("OutSize",), no_grad_inputs=("OutSize",))
def _bilinear_interp(ctx, x, out_size, attrs):
    """Bilinear resize of NCHW x (interpolate_op.h
    BilinearInterpolation); align_corners defaults to true, as in the
    reference op maker."""
    n, c, h, w = x.shape
    oh, ow = _interp_out_hw(attrs, h, w, out_size)
    ac = bool(attrs.get("align_corners", True))
    am = attrs.get("align_mode", 1)
    sy = _interp_src_coords(oh, h, ac, am, x.device)
    sx = _interp_src_coords(ow, w, ac, am, x.device)
    y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, h - 1)
    x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (sy - y0.float()).to(x.dtype)
    wx = (sx - x0.float()).to(x.dtype)
    rows0 = torch.index_select(x, 2, y0)
    rows1 = torch.index_select(x, 2, y1)
    top = rows0 * (1 - wy)[None, None, :, None] \
        + rows1 * wy[None, None, :, None]
    left = torch.index_select(top, 3, x0)
    right = torch.index_select(top, 3, x1)
    return left * (1 - wx)[None, None, None, :] \
        + right * wx[None, None, None, :]


@simple_op("nearest_interp", ["X", "OutSize"], ["Out"],
           optional=("OutSize",), no_grad_inputs=("OutSize",))
def _nearest_interp(ctx, x, out_size, attrs):
    """Nearest-neighbour resize of NCHW x (interpolate_op.h): with
    align_corners (the default) ratio·dst rounded half up, ratio
    (in-1)/(out-1); else floor with in/out."""
    n, c, h, w = x.shape
    oh, ow = _interp_out_hw(attrs, h, w, out_size)
    ac = bool(attrs.get("align_corners", True))
    iy = _interp_src_coords(oh, h, ac, 1, x.device)
    ix = _interp_src_coords(ow, w, ac, 1, x.device)
    if ac:
        iy, ix = torch.floor(iy + 0.5), torch.floor(ix + 0.5)
    else:
        iy, ix = torch.floor(iy), torch.floor(ix)
    iy = torch.clamp(iy.to(torch.int32), 0, h - 1)
    ix = torch.clamp(ix.to(torch.int32), 0, w - 1)
    return torch.index_select(torch.index_select(x, 2, iy), 3, ix)
