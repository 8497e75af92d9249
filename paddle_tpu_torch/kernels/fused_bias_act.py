"""K4: fused bias + GeLU (+ dropout mask) forward, and its plain backward.

Counterpart of ``paddle_tpu/kernels/fused_bias_act.py``, whose Pallas
kernel (``_pallas_chain`` :96) this replaces with the hand-written CUDA
kernel ``csrc/fused_bias_act.cu``.  The ``fuse_bias_act_dropout`` pass
(passes/fuse_bias_act.py) rewrites every FFN ``elementwise_add -> gelu``
chain to one ``fused_bias_act_dropout`` op whose lowering
(ops/fused_ops.py) calls :func:`fused_bias_gelu` here.

Bound: one elementwise pass, bytes-bound on paper; the source note in
the ``.cu`` file says why the first kernel was bound by issue instead,
and how the redesign (a 2-D grid with the bias in registers, 16-byte
streaming accesses, the exact GeLU as 2^(−u²)·P(q) in place of erfcf)
cuts the instructions an element.  x and bias are each float32,
bfloat16 or float16 (the bf16 dtype policy hands the training path bf16
activations, the fp16 AMP rewrite fp16 x with an fp32 bias); the kernel
computes in fp32 and returns x's dtype, rounded to nearest-even, as the
JAX function does (an fp16 result past fp16's range is ±inf).  The dropout
mask is drawn outside the kernel and passed in as uint8, as in the JAX
package.

The backward, :func:`fused_bias_gelu_dropout_grad`, is plain PyTorch:
the JAX package computes it in XLA outside any Pallas kernel
(``fused_bias_act.py:189``).

:func:`fused_bias_gelu` launches the kernel for a CUDA tensor and runs
the plain version, :func:`fused_bias_gelu_reference`, for a CPU tensor
(or a ``meta`` tensor during shape inference).  ``force="reference"``
selects the plain version explicitly; nothing on the decode or training
path sets it.  ``fused_bias_gelu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["gelu_reference", "fused_bias_gelu_reference",
           "fused_bias_gelu", "fused_bias_gelu_dropout_grad"]

# (x dtype, bias dtype, x, bias, mask, out, R, H, scale, approximate,
# stream)
_SIGNATURES = {
    "pt_fused_bias_gelu": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def gelu_reference(x, approximate=False):
    """GeLU spelled as ``jax.nn.gelu`` spells it: the exact form through
    erfc, the tanh form with x**3 as x*x*x."""
    if approximate:
        k = math.sqrt(2.0 / math.pi)
        cdf = 0.5 * (1.0 + torch.tanh(k * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))


def fused_bias_gelu_reference(x, bias, mask=None, scale=1.0,
                              approximate=False):
    """The plain version: ``gelu(x + bias) [* mask * scale]`` in fp32,
    returned in x's dtype."""
    y = gelu_reference(x.float() + bias.float(), approximate)
    if mask is not None:
        y = y * mask.float() * scale
    return y.to(x.dtype)


def _gelu_derivative(t, approximate):
    """d gelu(t) / dt in fp32, for the spellings of :func:`gelu_reference`."""
    if approximate:
        k = math.sqrt(2.0 / math.pi)
        th = torch.tanh(k * (t + 0.044715 * (t * t * t)))
        return 0.5 * (1.0 + th) + 0.5 * t * (1.0 - th * th) * k * (
            1.0 + 3 * 0.044715 * (t * t))
    pdf = torch.exp(-0.5 * t * t) * (1.0 / math.sqrt(2.0 * math.pi))
    return 0.5 * torch.erfc(-t * math.sqrt(0.5)) + t * pdf


def fused_bias_gelu_dropout_grad(x, bias, mask, dy, *, dropout_prob=0.0,
                                 is_test=False, approximate=False):
    """Backward of the fused chain through the saved mask:
    ``d_pre = gelu'(x + bias) · dy [· mask / (1 - p)]``; returns
    ``(dX = d_pre, dBias = Σ_rows d_pre)`` in x's and bias's dtypes."""
    pre = x.float() + bias.float()
    dyf = dy.float()
    if dropout_prob > 0.0 and not is_test and mask is not None:
        dyf = dyf * mask.float() / max(1.0 - dropout_prob, 1e-8)
    dpre = _gelu_derivative(pre, approximate) * dyf
    dbias = dpre.sum(dim=tuple(range(dpre.dim() - 1)))
    return dpre.to(x.dtype), dbias.to(bias.dtype)


def _check(x, bias, mask):
    if x.dim() < 1 or bias.dim() != 1 or bias.shape[0] != x.shape[-1]:
        raise ValueError(f"fused_bias_gelu: bias {tuple(bias.shape)} must be "
                         f"[H] for x {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_bias_gelu: x and bias must be float32, "
                        f"bfloat16 or float16, got {x.dtype} and "
                        f"{bias.dtype}")
    if mask is not None and (mask.dtype != torch.uint8
                             or mask.shape != x.shape):
        raise ValueError(f"fused_bias_gelu: mask must be uint8 of x's shape "
                         f"{tuple(x.shape)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for t in (bias, mask):
        if t is not None and t.device != x.device:
            raise ValueError(f"fused_bias_gelu: tensors on {x.device} and "
                             f"{t.device}")


def _use_kernel(x, force):
    """False for the plain version (``force="reference"``, a CPU or meta
    tensor); True for a CUDA tensor, which launches the kernel."""
    if force not in (None, "reference"):
        raise ValueError(f"fused_bias_gelu: force={force!r} (use None or "
                         f"'reference')")
    if force == "reference" or x.device.type in ("cpu", "meta"):
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_bias_gelu: no kernel for {x.device}")
    return True


def fused_bias_gelu(x, bias, mask=None, scale=1.0, approximate=False,
                    force=None):
    """``gelu(x + bias) [* mask * scale]`` over x [..., H] with bias [H]
    (each float32, bfloat16 or float16), computed in fp32; returns x's
    shape and dtype."""
    _check(x, bias, mask)
    if not _use_kernel(x, force):
        return fused_bias_gelu_reference(x, bias, mask, scale, approximate)
    for name, t in (("x", x), ("bias", bias), ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_bias_gelu: {name} must be contiguous")
    lib = _build.load("fused_bias_act", _SIGNATURES)
    h = x.shape[-1]
    out = torch.empty_like(x)
    err = lib.pt_fused_bias_gelu(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[bias.dtype],
        _build.ptr(x), _build.ptr(bias),
        _build.ptr(mask) if mask is not None else None, _build.ptr(out),
        x.numel() // h, h, float(scale), int(bool(approximate)),
        _build.stream_of(x.device))
    fused_bias_gelu.launches += 1
    _build.check("fused_bias_gelu", err)
    return out


fused_bias_gelu.launches = 0
