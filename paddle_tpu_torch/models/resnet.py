"""ResNet for image classification, Fluid graph-building style
(counterpart of ``paddle_tpu/models/resnet.py``: the same builders,
parameter names and op list).

Reference analog: the ResNet the reference trains in its book
image-classification workload (tests/book/test_image_classification.py).
Layout is NCHW, as the reference scripts'; on the card the convs run on
cuDNN, which takes NCHW.  ``build_resnet(depth=50)`` is the north-star
ResNet-50 ImageNet train step (He et al. 2016).
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid.param_attr import ParamAttr

DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None, is_test=False):
    conv = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False,
        param_attr=ParamAttr(name=name + "_weights"))
    return layers.batch_norm(
        input=conv, act=act, is_test=is_test,
        param_attr=ParamAttr(name=name + "_bn_scale"),
        bias_attr=ParamAttr(name=name + "_bn_offset"),
        moving_mean_name=name + "_bn_mean",
        moving_variance_name=name + "_bn_variance")


def shortcut(input, ch_out, stride, name, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2b", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          name=name + "_branch2c", is_test=is_test)
    short = shortcut(input, num_filters * 4, stride, name=name + "_branch1",
                     is_test=is_test)
    return layers.relu(layers.elementwise_add(short, conv2))


def basic_block(input, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None,
                          name=name + "_branch2b", is_test=is_test)
    short = shortcut(input, num_filters, stride, name=name + "_branch1",
                     is_test=is_test)
    return layers.relu(layers.elementwise_add(short, conv1))


def resnet(input, class_dim=1000, depth=50, is_test=False, prefix="res"):
    """Build the ResNet tower; returns the softmax prediction variable."""
    block_type, counts = DEPTH_CFG[depth]
    block_fn = bottleneck_block if block_type == "bottleneck" else basic_block
    num_filters = [64, 128, 256, 512]

    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                         name=prefix + "_conv1", is_test=is_test)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for stage, count in enumerate(counts):
        for blk in range(count):
            stride = 2 if blk == 0 and stage != 0 else 1
            # a-z suffixes up to 26 blocks, numeric beyond (ResNet-101/152
            # stage 3 exceeds the alphabet; keep names checkpoint/shard-safe)
            suffix = chr(97 + blk) if blk < 26 else f"b{blk}"
            conv = block_fn(conv, num_filters[stage], stride,
                            name=f"{prefix}{stage + 2}{suffix}",
                            is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax",
                     param_attr=ParamAttr(name=prefix + "_fc_weights"),
                     bias_attr=ParamAttr(name=prefix + "_fc_offset"))


def build_resnet(depth=50, class_dim=1000, image_shape=(3, 224, 224),
                 is_test=False):
    """Full training graph: data, tower, loss, accuracy.

    Returns (feed_names, prediction, avg_loss, acc).
    """
    img = fluid.data(name="img", shape=[-1] + list(image_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    prediction = resnet(img, class_dim=class_dim, depth=depth, is_test=is_test)
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, avg_loss, acc
