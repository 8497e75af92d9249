"""Ring-quantized all-reduce: int8 on every hop (counterpart of
``paddle_tpu/kernels/ring_collectives.py``).

The JAX package writes the ring on ``lax.ppermute`` under
``shard_map``.  Here a collective takes the list of every replica's
value (kernels/quantized_collectives.py says why), a ``ppermute`` by
``sign`` is a rotation of that list — replica j sends to replica
(j + sign) mod n, so replica i receives from (i - sign) mod n — and a
payload crossing replicas moves with ``.to(device)``.  The hop algebra
is the JAX package's, index for index:

  reduce-scatter (n-1 hops): replica i starts with its own shard
    (i - sign) mod n; at hop t the carried partial is quantized, sent
    one position on, dequantized by the receiver and added in fp32 to
    the receiver's shard (i - sign·(2 + t)) mod n.  After n-1 hops
    replica i holds the sum of chunk i.
  all-gather (n-1 hops): each replica quantizes its reduced chunk once;
    the same image is forwarded n-1 times, and after hop t the resident
    chunk came from replica (i - sign·(1 + t)) mod n, which is the slot
    it takes.

The bidirectional ring splits the payload (padded to 2·n·block_size)
into two halves that ride the sign +1 and sign -1 rings.
:func:`select_allreduce_algo` is the one place an algorithm is chosen:
the transpiler stamps its result on each op, so the lowering, the
wire-bytes model and the q-var shapes agree.

Not ported yet: ``quantized_all_gather`` and ``gather_quantized_shards``
(the ZeRO-1 gather, ROADMAP 5.3).
"""

from __future__ import annotations

import torch

from .quantized_collectives import (DEFAULT_BLOCK_SIZE,
                                    dequantize_block_scaled,
                                    quantize_block_scaled,
                                    quantized_all_reduce)

__all__ = [
    "QUANT_ALLREDUCE_ALGOS", "bidir_eligible", "select_allreduce_algo",
    "ring_quantized_all_reduce", "bidir_ring_quantized_all_reduce",
    "local_keep_quant", "adaptive_quantized_all_reduce",
    "adaptive_quantized_all_reduce_keep",
]

QUANT_ALLREDUCE_ALGOS = ("auto", "oneshot", "ring", "ring_bidir")


def _flag(name):
    from paddle_tpu_torch.fluid import flags as _flags

    return _flags.flag(name)


def bidir_eligible(n_elements, n_devices, block_size=None):
    """Whether the bidirectional ring is well-formed: more than 2
    replicas (at 2 both directions reach the same neighbour) and at
    least one block a direction a replica before padding."""
    if block_size is None:
        block_size = _flag("quant_allreduce_block_size")
    return (int(n_devices) > 2
            and int(n_elements) >= 2 * int(n_devices) * int(block_size))


def select_allreduce_algo(n_elements, n_devices, algo=None,
                          crossover_kb=None, block_size=None):
    """Resolve the quantized all-reduce algorithm for one tensor.

    ``algo`` None or "auto" defers to ``FLAGS_quant_allreduce_algo``; a
    resolved "auto" sends tensors of at least ``crossover_kb`` KB of fp32
    payload to the ring (the bidirectional one when
    :func:`bidir_eligible`) and smaller ones to the one-shot form; one
    replica always resolves "oneshot".  An explicit "ring_bidir" is
    demoted to "ring" when :func:`bidir_eligible` fails."""
    if algo in (None, "auto"):
        algo = _flag("quant_allreduce_algo")
    if algo == "ring_bidir":
        return ("ring_bidir"
                if bidir_eligible(n_elements, n_devices, block_size)
                else "ring")
    if algo in ("oneshot", "ring"):
        return algo
    if algo != "auto":
        raise ValueError(
            f"quant_allreduce algo must be one of {QUANT_ALLREDUCE_ALGOS}, "
            f"got {algo!r}")
    if int(n_devices) <= 1:
        return "oneshot"
    if crossover_kb is None:
        crossover_kb = _flag("quant_allreduce_crossover_kb")
    if int(n_elements) * 4 < float(crossover_kb) * 1024.0:
        return "oneshot"
    return ("ring_bidir" if bidir_eligible(n_elements, n_devices, block_size)
            else "ring")


def _quantize_permute(acc, sign, block_size, dual_int8):
    """One int8 hop: each replica quantizes its partial and sends it one
    position on; the receiver dequantizes.  Returns what each replica
    received."""
    n = len(acc)
    out = [None] * n
    for j, a in enumerate(acc):
        dst = (j + sign) % n
        dev = acc[dst].device
        hi, lo, sc = quantize_block_scaled(a, block_size, dual_int8)
        out[dst] = dequantize_block_scaled(
            hi.to(dev), lo.to(dev) if lo is not None else None, sc.to(dev),
            block_size)
    return out


def _ring_reduce_scatter(shards, block_size, dual_int8, sign=1):
    """Quantized ring reduce-scatter over ``shards`` (one [n, per_shard]
    fp32 tensor a replica): replica i returns the reduced chunk i."""
    n = len(shards)
    acc = [s[(i - sign) % n] for i, s in enumerate(shards)]
    for t in range(n - 1):
        received = _quantize_permute(acc, sign, block_size, dual_int8)
        acc = [received[i] + shards[i][(i - sign * (2 + t)) % n]
               for i in range(n)]
    return acc


def _ring_all_gather_quant(reduced, block_size, dual_int8, sign=1,
                           keep_quant=False):
    """Quantized ring all-gather of each replica's reduced chunk: the
    chunk is quantized once and the same image makes n-1 hops.  Returns
    the flat fp32 tensor a replica, or the assembled ``(hi, lo,
    scales)`` with ``keep_quant``."""
    n = len(reduced)
    cur = [quantize_block_scaled(r, block_size, dual_int8) for r in reduced]
    slots = []
    for i, (hi, lo, sc) in enumerate(cur):
        dev = reduced[i].device
        s_hi = torch.zeros((n,) + tuple(hi.shape), dtype=torch.int8,
                           device=dev)
        s_lo = (torch.zeros_like(s_hi) if dual_int8 else None)
        s_sc = torch.zeros((n,) + tuple(sc.shape), dtype=torch.float32,
                           device=dev)
        s_hi[i] = hi
        if dual_int8:
            s_lo[i] = lo
        s_sc[i] = sc
        slots.append((s_hi, s_lo, s_sc))
    for t in range(n - 1):
        # replica i receives from (i - sign): the image it forwarded last
        cur = [tuple(None if x is None else x.to(reduced[i].device)
                     for x in cur[(i - sign) % n]) for i in range(n)]
        for i, (hi, lo, sc) in enumerate(cur):
            src = (i - sign * (1 + t)) % n
            slots[i][0][src] = hi
            if dual_int8:
                slots[i][1][src] = lo
            slots[i][2][src] = sc
    outs = []
    for s_hi, s_lo, s_sc in slots:
        hi = s_hi.reshape(-1)
        lo = s_lo.reshape(-1) if dual_int8 else None
        sc = s_sc.reshape(-1)
        outs.append((hi, lo, sc) if keep_quant
                    else dequantize_block_scaled(hi, lo, sc, block_size))
    return outs


def _flat_padded(x, mult):
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % mult
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def ring_quantized_all_reduce(xs, block_size=DEFAULT_BLOCK_SIZE,
                              dual_int8=True, keep_quant=False):
    """Ring block-scaled int8 all-reduce-sum of ``xs`` (one tensor a
    replica): int8 + fp32 scales on every hop, fp32 accumulation at
    every reduction.  ``keep_quant`` returns the wire image padded to
    ``n * block_size``.  One replica: the identity (the local quantized
    image with ``keep_quant``)."""
    n, bs = len(xs), int(block_size)
    if n == 1:
        return ([local_keep_quant(xs[0], bs, dual_int8)] if keep_quant
                else list(xs))
    size, shape, dtype = xs[0].numel(), xs[0].shape, xs[0].dtype
    shards = [_flat_padded(x, n * bs).reshape(n, -1) for x in xs]
    reduced = _ring_reduce_scatter(shards, bs, dual_int8)
    outs = _ring_all_gather_quant(reduced, bs, dual_int8,
                                  keep_quant=keep_quant)
    if keep_quant:
        return outs
    return [o[:size].reshape(shape).to(dtype) for o in outs]


def bidir_ring_quantized_all_reduce(xs, block_size=DEFAULT_BLOCK_SIZE,
                                    dual_int8=True, keep_quant=False):
    """Bidirectional ring: the payload, padded to ``2 * n * block_size``,
    splits into halves on the sign +1 and sign -1 rings.  Falls back to
    the one-way ring below :func:`bidir_eligible`."""
    n, bs = len(xs), int(block_size)
    size, shape, dtype = xs[0].numel(), xs[0].shape, xs[0].dtype
    if not bidir_eligible(size, n, bs):
        return ring_quantized_all_reduce(xs, bs, dual_int8, keep_quant)
    flats = [_flat_padded(x, 2 * n * bs) for x in xs]
    half = flats[0].numel() // 2
    halves = []
    for sign, sl in ((1, slice(0, half)), (-1, slice(half, None))):
        shards = [f[sl].reshape(n, -1) for f in flats]
        reduced = _ring_reduce_scatter(shards, bs, dual_int8, sign=sign)
        halves.append(_ring_all_gather_quant(reduced, bs, dual_int8,
                                             sign=sign,
                                             keep_quant=keep_quant))
    if keep_quant:
        return [tuple(None if a is None else torch.cat([a, b])
                      for a, b in zip(cw, ccw))
                for cw, ccw in zip(*halves)]
    return [torch.cat([cw, ccw])[:size].reshape(shape).to(dtype)
            for cw, ccw in zip(*halves)]


def local_keep_quant(x, block_size, dual_int8=True):
    """The kept wire image of one replica's own value: flattened, padded
    to a block, quantized once (``c_allreduce_quant_keep`` outside a
    replica group)."""
    return quantize_block_scaled(_flat_padded(x, int(block_size)),
                                 int(block_size), dual_int8)


def _dispatch(xs, block_size, dual_int8, algo, crossover_kb, keep_quant):
    n = len(xs)
    if n == 1:
        return ([local_keep_quant(xs[0], block_size, dual_int8)]
                if keep_quant else list(xs))
    resolved = select_allreduce_algo(xs[0].numel(), n, algo=algo,
                                     crossover_kb=crossover_kb,
                                     block_size=block_size)
    fn = {"oneshot": quantized_all_reduce,
          "ring": ring_quantized_all_reduce,
          "ring_bidir": bidir_ring_quantized_all_reduce}[resolved]
    return fn(xs, block_size, dual_int8, keep_quant=keep_quant)


def adaptive_quantized_all_reduce(xs, block_size=DEFAULT_BLOCK_SIZE,
                                  dual_int8=True, algo="auto",
                                  crossover_kb=None):
    """Resolve the algorithm with :func:`select_allreduce_algo` and run
    it: what the ``c_allreduce_quant`` lowering calls."""
    return _dispatch(xs, block_size, dual_int8, algo, crossover_kb, False)


def adaptive_quantized_all_reduce_keep(xs, block_size=DEFAULT_BLOCK_SIZE,
                                       dual_int8=True, algo="auto",
                                       crossover_kb=None):
    """:func:`adaptive_quantized_all_reduce` that returns each replica's
    assembled wire image ``(hi, lo, scales)``, padded per the resolved
    algorithm (``quant_padded_elems``), without the final dequantization:
    what ``c_allreduce_quant_keep`` calls."""
    return _dispatch(xs, block_size, dual_int8, algo, crossover_kb, True)
