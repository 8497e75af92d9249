"""Tensor creation / manipulation / indexing op lowerings (counterpart
of ``paddle_tpu/ops/tensor_ops.py``).  The grads of ``lookup_table``,
``gather``, ``reshape2``, ``transpose2``, ``flatten2``, ``concat`` and
``slice`` are derived by the registry (autograd through the forward
lowering), and so are ``expand_as``'s, ``expand``'s and the squeezes'."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import register_op, simple_op

from .common import np_dtype, op_generator


def _shape(attrs):
    return tuple(int(s) for s in attrs.get("shape", [1]))


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


@simple_op("fill_constant", [], ["Out"], grad=None)
def _fill_constant(ctx, attrs):
    return torch.full(_shape(attrs), attrs.get("value", 0.0),
                      dtype=np_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)


@simple_op("fill_any_like", ["X"], ["Out"], grad=None)
def _fill_any_like(ctx, x, attrs):
    dtype = attrs.get("dtype")
    return torch.full_like(x, attrs.get("value", 0.0),
                           dtype=np_dtype(dtype) if dtype else None)


@simple_op("fill_constant_batch_size_like", ["Input"], ["Out"], grad=None)
def _fill_constant_batch_size_like(ctx, inp, attrs):
    """``shape`` filled with ``value``, its ``output_dim_idx`` dim taken
    from ``Input``'s ``input_dim_idx`` dim (the batch)."""
    shape = list(_shape(attrs))
    shape[attrs.get("output_dim_idx", 0)] = \
        inp.shape[attrs.get("input_dim_idx", 0)]
    return torch.full(shape, attrs.get("value", 0.0),
                      dtype=np_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)


@simple_op("fill_zeros_like", ["X"], ["Out"], grad=None)
def _fill_zeros_like(ctx, x, attrs):
    return torch.zeros_like(x)


@simple_op("assign", ["X"], ["Out"])
def _assign(ctx, x, attrs):
    """A copy of X: ops update scope tensors in place (``adam``), so the
    output must not share X's storage."""
    return x.clone()


@simple_op("assign_value", [], ["Out"], grad=None)
def _assign_value(ctx, attrs):
    """The attrs' values (``fp32_values``, else ``int32_values``, else
    ``int64_values``, the JAX lowering's order) as a tensor of ``shape``
    and ``dtype``.  A CUDA graph cannot capture a copy from pageable
    host memory, so the op makes its values on a device once, at its
    first run there (on the card the eager warm-up), and returns a copy
    of them each run; new attrs make them anew."""
    vals = attrs.get("fp32_values") or attrs.get("int32_values") \
        or attrs.get("int64_values")
    dt = np_dtype(attrs.get("dtype", "float32"))
    shape = tuple(int(s) for s in attrs.get("shape", [-1]))
    if ctx.device.type == "meta":
        return torch.empty(len(vals), dtype=dt, device="meta").reshape(shape)
    key = (ctx.device, dt, shape)
    made = getattr(ctx.cur_op, "_assigned", {})
    if made.get(key, (None,))[0] is not vals:
        made = {**made, key: (vals, torch.tensor(
            vals, dtype=dt, device=ctx.device).reshape(shape))}
        if ctx.cur_op is not None:
            ctx.cur_op._assigned = made
    return made[key][1].clone()


@simple_op("uniform_random", [], ["Out"], grad=None)
def _uniform_random(ctx, attrs):
    out = torch.empty(_shape(attrs),
                      dtype=np_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    if out.device.type == "meta":
        return out
    return out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                        generator=op_generator(ctx, attrs))


@simple_op("gaussian_random", [], ["Out"], grad=None)
def _gaussian_random(ctx, attrs):
    dt = np_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dt, device="meta")
    z = torch.randn(_shape(attrs), dtype=dt, device=ctx.device,
                    generator=op_generator(ctx, attrs))
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
           optional=("Shape", "ShapeTensor"),
           no_grad_inputs=("Shape", "ShapeTensor"))
def _reshape2(ctx, x, shape_t, shape_list, attrs):
    return x.reshape(_resolve_reshape(x, attrs.get("shape"))), None


@simple_op("transpose2", ["X"], ["Out", "XShape"])
def _transpose2(ctx, x, attrs):
    # a view: a consumer that needs contiguous memory asks for it
    return x.permute(*attrs.get("axis")), None


@simple_op("flatten2", ["X"], ["Out", "XShape"])
def _flatten2(ctx, x, attrs):
    """[prod(shape[:axis]), prod(shape[axis:])]."""
    ax = attrs.get("axis", 1)
    rows = 1
    for s in x.shape[:ax]:
        rows *= s
    return x.reshape(rows, -1), None


@simple_op("flatten", ["X"], ["Out"])
def _flatten(ctx, x, attrs):
    return _flatten2(ctx, x, attrs)[0]


@simple_op("squeeze2", ["X"], ["Out", "XShape"])
def _squeeze2(ctx, x, attrs):
    """X without its size-1 dims ``axes`` (every size-1 dim when none
    are given).  ``XShape`` is None, as in the JAX package."""
    axes = attrs.get("axes", [])
    if axes:
        return x.squeeze(tuple(a % x.dim() for a in axes)), None
    return x.squeeze(), None


@simple_op("squeeze", ["X"], ["Out"])
def _squeeze(ctx, x, attrs):
    return _squeeze2(ctx, x, attrs)[0]


@simple_op("unsqueeze2", ["X"], ["Out", "XShape"])
def _unsqueeze2(ctx, x, attrs):
    """X with a size-1 dim inserted at each of ``axes``, in ascending
    order.  ``XShape`` is None, as in the JAX package."""
    out = x
    for a in sorted(attrs.get("axes", [])):
        out = out.unsqueeze(a)
    return out, None


@simple_op("unsqueeze", ["X"], ["Out"])
def _unsqueeze(ctx, x, attrs):
    return _unsqueeze2(ctx, x, attrs)[0]


@simple_op("expand", ["X"], ["Out"])
def _expand(ctx, x, attrs):
    """X tiled ``expand_times`` times along each dim (``jnp.tile``);
    its derived grad sums the tiles.  Fewer times than dims tile the
    trailing dims, as ``jnp.tile`` does."""
    times = [int(t) for t in attrs.get("expand_times", [])]
    return x.repeat([1] * (x.dim() - len(times)) + times)


@simple_op("expand_as", ["X", "target_tensor"], ["Out"],
           no_grad_inputs=("target_tensor",))
def _expand_as(ctx, x, target, attrs):
    """X broadcast to ``target_tensor``'s shape (numpy's rule, as
    ``jnp.broadcast_to``); its derived grad sums over the broadcast
    dims."""
    return x.expand(target.shape)


@simple_op("concat", ["X*", "AxisTensor"], ["Out"], optional=("AxisTensor",),
           no_grad_inputs=("AxisTensor",))
def _concat(ctx, xs, axis_t, attrs):
    return torch.cat(xs, dim=attrs.get("axis", 0))


# ---------------------------------------------------------------------------
# indexing / embedding
# ---------------------------------------------------------------------------


def index_add_exact(rows, idx, src):
    """[rows, H] of ``src``'s rows summed by ``idx``, with a result no
    order of the adds can change.  Each table row's inputs are scaled by
    the power of two that its largest input fixes, so that any
    ``len(idx)`` of them fit 62 bits, and cut to 64-bit integers;
    integer adds commute exactly, so the atomics' order changes nothing.
    The cut loses under 2**-47 of the row's largest input at the train
    step's 16,384 ids, far below float32's rounding.  A row with a
    non-finite input reads nan."""
    top = torch.zeros(rows, dtype=torch.float64, device=src.device)
    top.scatter_reduce_(0, idx, src.abs().amax(1).double(), "amax")
    exp = (62 - max(1, src.shape[0] - 1).bit_length()
           - torch.frexp(top).exponent).double()
    q = (src * torch.exp2(exp)[idx, None]).long()  # the product is exact
    acc = torch.zeros(rows, src.shape[1], dtype=q.dtype, device=src.device)
    back = torch.where(torch.isfinite(top), torch.exp2(-exp), torch.nan)
    return (acc.index_add_(0, idx, q) * back[:, None]).to(src.dtype)


class _Lookup(torch.autograd.Function):
    """Rows of W by id; the grad sums each id's rows with
    :func:`index_add_exact`, so an eager run and a graph replay of the
    same step agree bit for bit.  The library's grads do not:
    ``index_select``'s (``index_add_``) and ``F.embedding``'s add
    float rows of a repeated id in an order that changes from run to
    run (on the card, at the train step's 16,384 ids over the 2-row
    token-type and 512-row position tables), and indexing's
    (``index_put_``, sorted) sums an id's rows on one warp, which takes
    milliseconds for the token-type table (chip_smoke.py
    ``time_lookup_grads`` times them all)."""

    @staticmethod
    def forward(ctx, w, flat):
        ctx.save_for_backward(flat)
        ctx.rows = w.shape[0]
        return w.index_select(0, flat)

    @staticmethod
    def backward(ctx, dout):
        (flat,) = ctx.saved_tensors
        return index_add_exact(ctx.rows, flat, dout), None


@simple_op("lookup_table", ["W", "Ids"], ["Out"], no_grad_inputs=("Ids",))
def _lookup_table(ctx, w, ids, attrs):
    """Embedding.  A trailing size-1 id dim is dropped from the output
    shape ([B, 1] ids -> [B, H]), as in the JAX package.  Its derived
    grad is deterministic (:class:`_Lookup`)."""
    pad = attrs.get("padding_idx", -1)
    flat = ids.reshape(-1).long()
    out = _Lookup.apply(w, flat)
    if pad is not None and pad >= 0:
        out = out.masked_fill((flat == pad)[:, None], 0)
    id_shape = tuple(ids.shape)
    if id_shape and id_shape[-1] == 1:
        id_shape = id_shape[:-1]
    return out.reshape(id_shape + (w.shape[-1],))


@simple_op("gather", ["X", "Index"], ["Out"], no_grad_inputs=("Index",))
def _gather(ctx, x, index, attrs):
    return x[index.long()]


@simple_op("arg_max", ["X"], ["Out"], grad=None)
def _arg_max(ctx, x, attrs):
    return torch.argmax(x, dim=attrs.get("axis", -1)).to(
        np_dtype(attrs.get("dtype", "int64")))


@simple_op("slice", ["Input"], ["Out"])
def _slice(ctx, x, attrs):
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs.get("axes", []), attrs.get("starts", []),
                       attrs.get("ends", [])):
        dim = x.shape[a]
        s2 = s if s >= 0 else max(dim + s, 0)
        e2 = min(e if e >= 0 else dim + e, dim)
        idx[a] = slice(s2, e2)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return out


@simple_op("sign", ["X"], ["Out"], grad=None)
def _sign(ctx, x, attrs):
    return torch.sign(x)


@simple_op("top_k", ["X", "K"], ["Out", "Indices"], grad=None,
           optional=("K",))
def _top_k(ctx, x, k_t, attrs):
    vals, idx = torch.topk(x, attrs.get("k", 1), dim=-1)
    return vals, idx.to(torch.int64)


@simple_op("accuracy", ["Out", "Indices", "Label"],
           ["Accuracy", "Correct", "Total"], grad=None, optional=("Out",))
def _accuracy(ctx, out, indices, label, attrs):
    lbl = label if label.dim() == indices.dim() else label[..., None]
    correct_rows = (indices == lbl.to(indices.dtype)).any(dim=-1)
    total = torch.full((), correct_rows.shape[0], dtype=torch.int32,
                       device=indices.device)
    correct = correct_rows.to(torch.int32).sum().to(torch.int32)
    return correct.float() / total.float(), correct, total


@simple_op("increment", ["X"], ["Out"], grad=None)
def _increment(ctx, x, attrs):
    """X + step in X's dtype (a step cast to an integer dtype truncates,
    as ``jnp.asarray(step, x.dtype)`` does)."""
    step = attrs.get("step", 1.0)
    return x + (step if x.is_floating_point() else int(step))


@simple_op("split", ["X"], ["Out*"])
def _split(ctx, x, attrs):
    """``num`` equal parts, or the given ``sections``, along ``axis``
    (grad derived)."""
    axis = attrs.get("axis", 0)
    sections = list(attrs.get("sections", []) or [])
    if not sections:
        num = int(attrs.get("num", 0))
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} parts")
        sections = [x.shape[axis] // num] * num
    return (list(torch.split(x, sections, dim=axis)),)


# split_op.cc's by-reference twin, as the JAX package's alias (no grad)
register_op("split_byref", ["X"], ["Out*"], _split, grad=None)


@simple_op("stack", ["X*"], ["Y"])
def _stack(ctx, xs, attrs):
    return torch.stack(list(xs), dim=attrs.get("axis", 0))


@simple_op("unstack", ["X"], ["Y*"])
def _unstack(ctx, x, attrs):
    return (list(torch.unbind(x, dim=attrs.get("axis", 0))),)


def _one_hot_rows(ids, depth):
    """fp32 one-hot rows of ``ids`` over ``depth`` classes; an id outside
    [0, depth) gives a zero row, as ``jax.nn.one_hot`` does (where
    ``F.one_hot`` raises)."""
    classes = torch.arange(depth, device=ids.device)
    return (ids.long()[..., None] == classes).to(torch.float32)


@simple_op("one_hot", ["X"], ["Out"], grad=None)
def _one_hot(ctx, x, attrs):
    """A trailing dim of 1 is squeezed first ([B, 1] ids give [B,
    depth]), as in the JAX op."""
    sq = x.squeeze(-1) if x.dim() and x.shape[-1] == 1 else x
    return _one_hot_rows(sq, int(attrs["depth"]))


@simple_op("one_hot_v2", ["X"], ["Out"], grad=None)
def _one_hot_v2(ctx, x, attrs):
    return _one_hot_rows(x, int(attrs["depth"]))


@simple_op("where", ["Condition", "X", "Y"], ["Out"],
           no_grad_inputs=("Condition",))
def _where(ctx, c, x, y, attrs):
    return torch.where(c.bool(), x, y)
