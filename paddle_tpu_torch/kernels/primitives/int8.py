"""Dual-int8 storage quantization of the KV cache and of weights
(counterpart of ``paddle_tpu/kernels/primitives/int8.py``).

The codec is the block-scaled symmetric int8 format of
``kernels/quantized_collectives.py``, imported from there as the JAX
package's ``primitives/int8.py`` imports it, so the bit-exact arithmetic
lives in one place: each block carries one fp32 scale; ``hi`` is the
int8 code of x/scale and ``lo`` the int8 code of the residual at
scale/254 resolution, both clipped to ±127.  The KV cache treats each
``head_dim`` vector as one block (:func:`quantize_lastdim`), so the pool
becomes hi/lo int8 ``[P, page, n, d]`` plus a scale fp32
``[P, page, n, 1]``, quantized once at append (ops/decode_ops.py) and
dequantized inside the paged-attention kernel (primitives/paged.py, K7).

The arithmetic is the JAX package's, step for step: scale =
max(amax/127, 1e-30) (a NaN block keeps its NaN scale), hi =
clip(round(x / scale)) by division, lo =
clip(round(resid * (254 / scale))) with that association, and
``torch.round`` rounds half to even as ``jnp.round`` does.

Weights: the ``int8_weight_storage`` pass (passes/int8_weights.py)
stores each claimed [r, c] weight with :func:`quantize_lastdim`, one
scale a row, and ``dequantize_weight_storage`` rebuilds it inside each
program run; :func:`quantize_weight` is the flat block layout of the
collectives' wire format applied to a weight at rest.
"""

from __future__ import annotations

import torch

from ..quantized_collectives import (DEFAULT_BLOCK_SIZE, QMAX, RESID_DIV,
                                     dequantize_block_scaled,
                                     quantize_block_scaled)

__all__ = ["QMAX", "RESID_DIV", "quantize_block_scaled",
           "dequantize_block_scaled", "quantize_lastdim",
           "dequantize_lastdim", "quantize_weight", "dequantize_weight",
           "dual_int8_bytes", "bytes_saved", "book_bytes_saved"]


def quantize_lastdim(x):
    """Dual-int8 with one block per last-axis vector: ``(hi, lo,
    scale)``, hi/lo int8 of x's shape and scale fp32
    ``x.shape[:-1] + (1,)`` — the KV-cache layout, one scale per
    (token, head) vector."""
    d = int(x.shape[-1])
    hi, lo, scales = quantize_block_scaled(x.reshape(-1, d), d)
    shape = tuple(x.shape)
    return (hi.reshape(shape), lo.reshape(shape),
            scales.reshape(shape[:-1] + (1,)))


def dequantize_lastdim(hi, lo, scale):
    """Inverse of :func:`quantize_lastdim`: (hi + lo/254)·scale in fp32,
    the arithmetic the K7 kernel does in registers."""
    return (hi.float() + lo.float() * (1.0 / RESID_DIV)) * scale.float()


def quantize_weight(w, block_size=DEFAULT_BLOCK_SIZE):
    """Flat block-scaled dual-int8 of a weight of any shape: ``(hi, lo,
    scales, pad)``, hi/lo int8 ``[padded_numel]``, scales fp32
    ``[padded_numel / block_size]``, and ``pad`` the zeros appended to
    reach a whole block."""
    flat = w.reshape(-1).float()
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    hi, lo, scales = quantize_block_scaled(flat, block_size)
    return hi, lo, scales, int(pad)


def dequantize_weight(hi, lo, scales, shape, block_size=DEFAULT_BLOCK_SIZE):
    """Inverse of :func:`quantize_weight` back to fp32 ``shape``."""
    flat = dequantize_block_scaled(hi, lo, scales, block_size)
    n = 1
    for d in shape:
        n *= int(d)
    return flat[:n].reshape(tuple(shape))


def dual_int8_bytes(n_elements, block_size):
    """Bytes at rest for ``n_elements`` in the dual-int8 format: 2 per
    element (hi + lo) + 4 per block (the fp32 scale)."""
    n = int(n_elements)
    blocks = -(-n // int(block_size))
    return 2 * n + 4 * blocks


def bytes_saved(n_elements, block_size, fp_bytes=4):
    """Modeled device-memory saving of storing ``n_elements`` dual-int8
    instead of ``fp_bytes``-wide floats (>= 0)."""
    return max(0, int(n_elements) * int(fp_bytes)
               - dual_int8_bytes(n_elements, block_size))


def book_bytes_saved(kind, n_bytes):
    """Book a storage saving on ``pt_int8_bytes_saved_total{kind}``
    (kind: "kv_cache" or "weights")."""
    from paddle_tpu_torch.observability import metrics as obs

    obs.counter(
        "pt_int8_bytes_saved_total",
        "Modeled device bytes saved by int8 storage quantization vs the "
        "fp32 layout it replaced (dual-int8: 2 bytes/elem + 4/block "
        "scale), booked once per quantized artifact",
        labels=("kind",),
    ).labels(kind=kind).inc(float(n_bytes))
