"""Tensor creation / manipulation / indexing op lowerings (counterpart
of ``paddle_tpu/ops/tensor_ops.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op

from .common import np_dtype


def _shape(attrs):
    return tuple(int(s) for s in attrs.get("shape", [1]))


def _op_generator(ctx, attrs):
    """A random op with a nonzero `seed` attr draws its own stream; the
    rest draw from the run's generator in program order."""
    seed = int(attrs.get("seed", 0) or 0)
    if not seed:
        return ctx.generator
    g = torch.Generator(device=ctx.device)
    g.manual_seed(seed)
    return g


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


@simple_op("fill_constant", [], ["Out"])
def _fill_constant(ctx, attrs):
    return torch.full(_shape(attrs), attrs.get("value", 0.0),
                      dtype=np_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)


@simple_op("uniform_random", [], ["Out"])
def _uniform_random(ctx, attrs):
    out = torch.empty(_shape(attrs),
                      dtype=np_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    if out.device.type == "meta":
        return out
    return out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                        generator=_op_generator(ctx, attrs))


@simple_op("gaussian_random", [], ["Out"])
def _gaussian_random(ctx, attrs):
    dt = np_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dt, device="meta")
    z = torch.randn(_shape(attrs), dtype=dt, device=ctx.device,
                    generator=_op_generator(ctx, attrs))
    return attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z


@simple_op("cast", ["X"], ["Out"])
def _cast(ctx, x, attrs):
    return x.to(np_dtype(attrs.get("out_dtype", attrs.get("dtype",
                                                          "float32"))))


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def _resolve_reshape(x, shape):
    """Fluid reshape: 0 copies the input dim at that position; a single
    -1 is inferred."""
    return tuple(x.shape[i] if s == 0 else int(s)
                 for i, s in enumerate(shape))


@simple_op("reshape2", ["X", "Shape", "ShapeTensor*"], ["Out", "XShape"],
           optional=("Shape", "ShapeTensor"))
def _reshape2(ctx, x, shape_t, shape_list, attrs):
    return x.reshape(_resolve_reshape(x, attrs.get("shape"))), None


@simple_op("transpose2", ["X"], ["Out", "XShape"])
def _transpose2(ctx, x, attrs):
    # a view: a consumer that needs contiguous memory asks for it
    return x.permute(*attrs.get("axis")), None


# ---------------------------------------------------------------------------
# indexing / embedding
# ---------------------------------------------------------------------------


@simple_op("lookup_table", ["W", "Ids"], ["Out"])
def _lookup_table(ctx, w, ids, attrs):
    """Embedding.  A trailing size-1 id dim is dropped from the output
    shape ([B, 1] ids -> [B, H]), as in the JAX package."""
    pad = attrs.get("padding_idx", -1)
    flat = ids.reshape(-1).long()
    out = torch.index_select(w, 0, flat)
    if pad is not None and pad >= 0:
        out = out.masked_fill((flat == pad)[:, None], 0)
    id_shape = tuple(ids.shape)
    if id_shape and id_shape[-1] == 1:
        id_shape = id_shape[:-1]
    return out.reshape(id_shape + (w.shape[-1],))


@simple_op("gather", ["X", "Index"], ["Out"])
def _gather(ctx, x, index, attrs):
    return x[index.long()]


@simple_op("arg_max", ["X"], ["Out"])
def _arg_max(ctx, x, attrs):
    return torch.argmax(x, dim=attrs.get("axis", -1)).to(
        np_dtype(attrs.get("dtype", "int64")))
