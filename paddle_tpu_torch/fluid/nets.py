"""Composed networks (counterpart of ``paddle_tpu/fluid/nets.py``):
conv + pool blocks of layers.  Ported so far: ``simple_img_conv_pool``
and ``img_conv_group``, which the image models build with."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group"]


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
