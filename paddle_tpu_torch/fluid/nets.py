"""Composed networks (counterpart of ``paddle_tpu/fluid/nets.py``):
conv + pool blocks (``simple_img_conv_pool``, ``img_conv_group``), the
sequence conv + pool (``sequence_conv_pool``), the gated linear unit
(``glu``) and multi-head ``scaled_dot_product_attention``."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   is_test=False):
    """A VGG conv group: convs (each with batch norm and dropout where
    asked), then one pool.  ``is_test`` reaches the group's batch_norm
    and dropout ops, as in the JAX package."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("img_conv_group: conv_num_filter must be a list")

    def _expand(x):
        return (x if isinstance(x, (list, tuple))
                else [x] * len(conv_num_filter))

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(len(conv_num_filter)):
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i],
            act=None if conv_with_batchnorm[i] else conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act,
                                    is_test=is_test)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate,
                                     is_test=is_test)
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr,
                                    bias_attr=bias_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in half along ``dim``, a · sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled-dot-product attention over [batch, seq, hidden]
    vars, composed of matmul and softmax ops."""
    head_dim = queries.shape[-1] // num_heads

    def split_heads(x):
        if num_heads == 1:
            return x
        r = layers.reshape(x, shape=[0, 0, num_heads,
                                     x.shape[-1] // num_heads])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    product = layers.matmul(q, k, transpose_y=True,
                            alpha=float(head_dim) ** -0.5)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    if num_heads == 1:
        return ctx
    t = layers.transpose(ctx, perm=[0, 2, 1, 3])
    return layers.reshape(t, shape=[0, 0, t.shape[2] * t.shape[3]])
