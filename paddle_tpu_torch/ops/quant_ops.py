"""Simulated-quantization ops and the int8 weight-storage reconstruction
(counterpart of ``paddle_tpu/ops/quant_ops.py``).

The fake quantize/dequantize ops are straight-through estimators: the
forward quantize-dequantizes (round(x / scale * range) * scale / range),
the backward passes the gradient through unchanged — written as
``x + (q - x).detach()``, so the registry's derived grad op is the
identity.  They are plain PyTorch, as they are plain XLA in the JAX
package.  Divisions are by tensors (``_div``): PyTorch turns a division
by a Python float on the card into a multiply by its reciprocal, which
rounds otherwise than the JAX package's true division.

``dequantize_weight_storage`` is what the ``int8_weight_storage`` pass
(passes/int8_weights.py) puts in front of every weight it stores
dual-int8: Out = (Hi + Lo / 254) * Scale.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op


def _div(a, v):
    """``a / v`` as an IEEE division by the Python number ``v``."""
    return a / torch.full_like(a, v)


def _ste(x, quantized):
    """Straight-through: forward ``quantized``, gradient of identity."""
    return x + (quantized - x).detach()


def _qdq(x, scale, qrange):
    """Quantize-dequantize at ``scale`` (saturating)."""
    s = torch.clamp_min(scale, 1e-9)
    q = torch.clamp(torch.round(x / s * qrange), -qrange, qrange)
    return _div(q * s, qrange)


def _qrange(attrs):
    return float((1 << (int(attrs.get("bit_length", 8)) - 1)) - 1)


def _is_test(ctx, attrs):
    return ctx.is_test or bool(attrs.get("is_test", False))


def _scalar(t):
    """A [1]-shaped (or scalar) fp32 state tensor as a 0-d fp32 tensor."""
    return t.reshape(()).float()


@simple_op("fake_quantize_abs_max", ["X"], ["Out", "OutScale"])
def _fake_quantize_abs_max(ctx, x, attrs):
    """scale = max|x|; simulated int<bits> quantization."""
    qrange = _qrange(attrs)
    scale = x.abs().amax().float()
    out = _ste(x, _qdq(x.float(), scale, qrange).to(x.dtype))
    return out, scale.reshape(1)


@simple_op("fake_channel_wise_quantize_abs_max", ["X"], ["Out", "OutScale"])
def _fake_channel_wise_quantize(ctx, x, attrs):
    """One scale per index of ``quant_axis`` (0 for conv filters, 1 for
    mul/matmul weights [in, out])."""
    axis = int(attrs.get("quant_axis", 0))
    qrange = _qrange(attrs)
    reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
    scales = x.float().abs().amax(dim=reduce_dims)
    shape = [1] * x.dim()
    shape[axis] = -1
    out = _ste(x, _qdq(x.float(), scales.reshape(shape), qrange).to(x.dtype))
    return out, scales


@simple_op("fake_quantize_range_abs_max",
           ["X", "InScale", "InScales", "Iter"],
           ["Out", "OutScale", "OutScales", "IterOut"],
           optional=("InScales", "Iter"),
           no_grad_inputs=("InScale", "InScales", "Iter"),
           inplace={"OutScale": "InScale", "OutScales": "InScales",
                    "IterOut": "Iter"})
def _fake_quantize_range_abs_max(ctx, x, in_scale, in_scales, it, attrs):
    """Windowed-max scale: the batch abs-max goes into a circular window
    (InScales [window_size]) and the scale is the window's max; frozen
    InScale in eval; a running max when no window is wired."""
    window = int(attrs.get("window_size", 10000))
    qrange = _qrange(attrs)
    batch_max = x.abs().amax().float()
    if _is_test(ctx, attrs):
        scale = _scalar(in_scale)
        new_scales, new_iter = in_scales, it
    elif in_scales is not None:
        if it is not None:
            step = it.reshape(()).long()
        else:
            step = torch.tensor(ctx.step, dtype=torch.long,
                                device=x.device)
        buf = in_scales.reshape(-1).float().clone()
        buf.index_put_(((step % window).reshape(1),), batch_max.reshape(1))
        scale = buf.amax()
        new_scales = buf
        new_iter = ((step + 1).reshape(1).to(it.dtype) if it is not None
                    else it)
    else:
        scale = torch.maximum(_scalar(in_scale), batch_max)
        new_scales, new_iter = in_scales, it
    out = _ste(x, _qdq(x.float(), scale, qrange).to(x.dtype))
    return out, scale.reshape(1), new_scales, new_iter


def _state(x, accum, state):
    """The EMA state (accum, state) as 0-d fp32 tensors, 0 when absent."""
    zero = x.new_zeros((), dtype=torch.float32)
    return (_scalar(accum) if accum is not None else zero,
            _scalar(state) if state is not None else zero)


def _ema(x, accum, state, rate):
    """accum = rate*accum + max|x|; state = rate*state + 1."""
    a, s = _state(x, accum, state)
    return rate * a + x.abs().amax().float(), rate * s + 1.0


@simple_op("fake_quantize_moving_average_abs_max",
           ["X", "InScale", "InAccum", "InState"],
           ["Out", "OutScale", "OutAccum", "OutState"],
           optional=("InAccum", "InState"),
           no_grad_inputs=("InScale", "InAccum", "InState"),
           inplace={"OutScale": "InScale", "OutAccum": "InAccum",
                    "OutState": "InState"})
def _fake_quantize_moving_avg(ctx, x, in_scale, accum, state, attrs):
    """EMA of the batch abs-max: scale = accum / state; frozen in eval."""
    rate = float(attrs.get("moving_rate", 0.9))
    qrange = _qrange(attrs)
    if _is_test(ctx, attrs):
        scale = _scalar(in_scale)
        new_accum, new_state = accum, state
    else:
        a, s = _ema(x, accum, state, rate)
        scale = a / torch.clamp_min(s, 1e-9)
        new_accum, new_state = a.reshape(1), s.reshape(1)
    out = _ste(x, _qdq(x.float(), scale, qrange).to(x.dtype))
    return out, scale.reshape(1), new_accum, new_state


@simple_op("moving_average_abs_max_scale", ["X", "InAccum", "InState"],
           ["Out", "OutScale", "OutAccum", "OutState"],
           optional=("InAccum", "InState"),
           no_grad_inputs=("InAccum", "InState"),
           inplace={"OutAccum": "InAccum", "OutState": "InState"})
def _moving_average_abs_max_scale(ctx, x, accum, state, attrs):
    """Observe-only: tracks the EMA scale (frozen in eval), passes x
    through."""
    rate = float(attrs.get("moving_rate", 0.9))
    if _is_test(ctx, attrs):
        a, s = _state(x, accum, state)
    else:
        a, s = _ema(x, accum, state, rate)
    scale = a / torch.clamp_min(s, 1e-9)
    return x, scale.reshape(1), a.reshape(1), s.reshape(1)


@simple_op("fake_dequantize_max_abs", ["X", "Scale"], ["Out"],
           no_grad_inputs=("Scale",))
def _fake_dequantize_max_abs(ctx, x, scale, attrs):
    """x * scale / max_range."""
    max_range = float(attrs.get("max_range", 127.0))
    return _div(x.float() * _scalar(scale), max_range).to(x.dtype)


@simple_op("dequantize_weight_storage", ["Hi", "Lo", "Scale"], ["Out"],
           grad=None)
def _dequantize_weight_storage(ctx, hi, lo, scale, attrs):
    """An fp32 weight from its dual-int8 storage (Scale per row, [r, 1]),
    the arithmetic of ``kernels/primitives/int8.py dequantize_lastdim``.
    Inference only: the pass never claims a weight a backward op reads."""
    from paddle_tpu_torch.kernels.primitives import int8 as _int8

    return _int8.dequantize_lastdim(hi, lo, scale)
