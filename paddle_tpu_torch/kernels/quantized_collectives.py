"""Quantized gradient all-reduce: block-scaled dual-int8 collectives over
a replica group (counterpart of
``paddle_tpu/kernels/quantized_collectives.py``).

The JAX package runs these under ``shard_map``: one traced body per
device, with ``lax.all_to_all`` and ``lax.all_gather`` between them.
The port drives every replica from one process (parallel/mesh.py), so
a collective here takes the list of every replica's value and returns
the list of every replica's result.  "Send shard i of each replica to
replica i" is an index over that list, and a tensor crossing to another
replica moves to that replica's device with ``.to(device)`` (a no-op
when the replicas share a card).

The one-shot form, step for step as in the JAX package:

  1. flatten and zero-pad to a multiple of ``n * block_size``, view as n
     shards (no block straddles a shard boundary);
  2. quantize each shard block-scaled (int8 hi, int8 residual lo, one
     fp32 scale a block);
  3. scatter: replica i receives shard i of every replica;
  4. dequantize the n contributions and sum them in fp32, in replica
     order;
  5. requantize the reduced shard;
  6. gather: every replica receives every reduced shard; dequantize,
     unpad, restore shape and dtype — or, with ``keep_quant``, return
     the assembled wire image (hi, lo, scales) for the fused optimizer
     ops (kernels/fused_update.py, K8).

The codec is the JAX package's arithmetic exactly: scale =
max(amax/127, 1e-30) by division (a NaN block keeps its NaN scale, as
``jnp.maximum`` does), hi = clip(round(x / scale)), lo =
clip(round(resid * (254 / scale))), and ``torch.round`` rounds half to
even as ``jnp.round`` does — so the kept codes are the JAX package's,
bit for bit (tests/test_torch_port_data_parallel.py).

Gradients: none.  The JAX collectives carry a straight-through VJP; the
data-parallel lane never differentiates through a collective (they sit
after the backward's gradient producers), so the port registers them
without grad ops.
"""

from __future__ import annotations

import torch

__all__ = [
    "QMAX", "RESID_DIV", "DEFAULT_BLOCK_SIZE",
    "quantize_block_scaled", "dequantize_block_scaled",
    "quant_padded_elems", "wire_bytes", "gather_wire_bytes",
    "sum_in_order", "quantized_all_reduce",
]

DEFAULT_BLOCK_SIZE = 256

QMAX = 127.0  # symmetric int8 range: never -128
RESID_DIV = 2.0 * QMAX  # the residual is bounded by scale/2


def quant_padded_elems(n_elements, n_devices, block_size=DEFAULT_BLOCK_SIZE,
                       algo="oneshot"):
    """Padded element count of one quantized all-reduce payload, the
    static shape of the kept wire image: oneshot and ring pad to a
    multiple of ``n_devices * block_size``, the bidirectional ring to
    ``2 * n_devices * block_size``; one device pads to one block."""
    n, d, bs = int(n_elements), max(1, int(n_devices)), int(block_size)
    mult = (2 * d * bs) if algo == "ring_bidir" else (d * bs)
    if d <= 1:
        mult = bs
    return n + (-n) % mult


def wire_bytes(n_elements, block_size=DEFAULT_BLOCK_SIZE, dual_int8=True,
               n_devices=2, algo="oneshot"):
    """Modeled bytes one replica moves for one quantized all-reduce of
    ``n_elements`` (both phases): int8 hi (+ lo when dual) plus one fp32
    scale a block.  oneshot moves the whole padded payload at each
    phase; the rings move ``2*(n-1)/n`` of it; ``ring_bidir`` the same
    fraction of two half-images (demoted to the ring where
    ``ring_collectives.bidir_eligible`` would fail).  0 on one device."""
    n = int(n_elements)
    d = int(n_devices)
    bs = int(block_size)
    if n <= 0 or d <= 1:
        return 0
    per_elem = 2 if dual_int8 else 1

    def payload_of(elems):
        return elems * per_elem + (elems // bs) * 4

    if algo == "ring_bidir" and (d <= 2 or n < 2 * d * bs):
        algo = "ring"
    if algo == "ring_bidir":
        half = quant_padded_elems(n, d, bs, algo="ring_bidir") // 2
        return 2 * (2 * (d - 1) * (payload_of(half) // d))
    padded = n + (-n) % (d * bs)
    payload = payload_of(padded)
    if algo == "oneshot":
        return 2 * payload
    if algo == "ring":
        return 2 * (d - 1) * (payload // d)
    raise ValueError(f"wire_bytes: unknown algo {algo!r} "
                     f"(expected 'oneshot', 'ring' or 'ring_bidir')")


def gather_wire_bytes(n_elements, block_size=DEFAULT_BLOCK_SIZE,
                      dual_int8=True, n_devices=2):
    """Modeled bytes one replica receives in a quantized all-gather of
    shards of ``n_elements``: n-1 foreign shard images, each padded to a
    block multiple."""
    n = int(n_elements)
    d = int(n_devices)
    if n <= 0 or d <= 1:
        return 0
    padded = n + (-n) % int(block_size)
    per_elem = 2 if dual_int8 else 1
    n_blocks = padded // int(block_size)
    return (d - 1) * (padded * per_elem + n_blocks * 4)


def _const(like, value):
    """``value`` as a tensor of ``like``'s shape: a division by it is an
    IEEE division.  PyTorch turns ``tensor / python_float`` on CUDA into
    a multiply by the reciprocal and ``python_float / tensor`` everywhere
    into ``reciprocal(tensor) * value``; both round otherwise than the
    JAX package's (and kernel K8's) true division."""
    return torch.full_like(like, value)


def quantize_block_scaled(x, block_size=DEFAULT_BLOCK_SIZE, dual_int8=True):
    """Block-scaled symmetric int8 of a float tensor whose size is a
    multiple of ``block_size``: ``(hi, lo, scales)``, hi/lo int8 of x's
    shape (lo None when not ``dual_int8``) and one fp32 scale a block."""
    xf = x.float().reshape(-1, block_size)
    amax = xf.abs().amax(dim=1, keepdim=True)
    # an all-zero block gets a tiny scale and quantizes to exact zeros;
    # clamp_min keeps a NaN block's NaN scale, as jnp.maximum does
    scale = (amax / _const(amax, QMAX)).clamp_min(1e-30)
    q_hi = torch.clamp(torch.round(xf / scale), -QMAX, QMAX)
    if not dual_int8:
        return q_hi.to(torch.int8).reshape(x.shape), None, scale[:, 0]
    resid = xf - q_hi * scale
    q_lo = torch.clamp(torch.round(resid * (_const(scale, RESID_DIV)
                                            / scale)), -QMAX, QMAX)
    return (q_hi.to(torch.int8).reshape(x.shape),
            q_lo.to(torch.int8).reshape(x.shape), scale[:, 0])


def dequantize_block_scaled(q_hi, q_lo, scales, block_size=DEFAULT_BLOCK_SIZE):
    """Inverse of :func:`quantize_block_scaled` (fp32, x's shape)."""
    hi = q_hi.float().reshape(-1, block_size)
    s = scales.reshape(-1, 1)
    out = hi * s
    if q_lo is not None:
        out = out + q_lo.float().reshape(-1, block_size) \
            * (s / _const(s, RESID_DIV))
    return out.reshape(q_hi.shape)


def sum_in_order(parts):
    """Sum over dim 0 one row after another (((a + b) + c) + d), the
    order of XLA's reduce over a short leading axis, so the reduced fp32
    values — and the codes quantized from them — match the JAX
    package's."""
    acc = parts[0]
    for k in range(1, parts.shape[0]):
        acc = acc + parts[k]
    return acc


def quantized_all_reduce(xs, block_size=DEFAULT_BLOCK_SIZE, dual_int8=True,
                         keep_quant=False):
    """The one-shot block-scaled int8 all-reduce-sum of ``xs`` (one
    tensor a replica, same shape).  Returns one result a replica: the
    sum in each input's shape and dtype, or with ``keep_quant`` the
    assembled wire image ``(hi, lo, scales)``, flat, padded to
    ``n * block_size``.  One replica: the identity (``keep_quant``
    callers take ``ring_collectives.local_keep_quant`` first)."""
    n = len(xs)
    if n == 1:
        return list(xs)
    bs = int(block_size)
    orig_shape, orig_dtype = xs[0].shape, xs[0].dtype
    size = xs[0].numel()
    pad = (-size) % (n * bs)
    per_shard = (size + pad) // n
    sent = []
    for x in xs:
        flat = x.reshape(-1).float()
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        q_hi, q_lo, sc = quantize_block_scaled(flat.reshape(n, per_shard),
                                               bs, dual_int8)
        sent.append((q_hi, q_lo, sc.reshape(n, per_shard // bs)))
    # scatter phase: row i of every replica's payload goes to replica i
    reduced = []
    for i, x in enumerate(xs):
        dev = x.device
        hi = torch.stack([s[0][i].to(dev) for s in sent])
        lo = (torch.stack([s[1][i].to(dev) for s in sent])
              if dual_int8 else None)
        sc = torch.stack([s[2][i].to(dev) for s in sent])
        parts = dequantize_block_scaled(hi, lo, sc, bs)
        reduced.append(quantize_block_scaled(sum_in_order(parts), bs,
                                             dual_int8))
    # gather phase: every reduced shard to every replica
    outs = []
    for x in xs:
        dev = x.device
        g_hi = torch.stack([r[0].to(dev) for r in reduced]).reshape(-1)
        g_lo = (torch.stack([r[1].to(dev) for r in reduced]).reshape(-1)
                if dual_int8 else None)
        g_sc = torch.stack([r[2].to(dev) for r in reduced]).reshape(-1)
        if keep_quant:
            outs.append((g_hi, g_lo, g_sc))
            continue
        out = dequantize_block_scaled(g_hi, g_lo, g_sc, bs)[:size]
        outs.append(out.reshape(orig_shape).to(orig_dtype))
    return outs
