"""SE-ResNeXt for image classification, Fluid graph-building style
(counterpart of ``paddle_tpu/models/se_resnext.py``).

Reference analog: the model the reference uses as its flagship
distributed CNN workload (python/paddle/fluid/tests/unittests/
dist_se_resnext.py): ResNeXt grouped-convolution bottlenecks
(cardinality 32/64) with squeeze-and-excitation channel gating (a
global pool, two small FCs and a broadcast multiply).
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid.param_attr import ParamAttr

from .resnet import conv_bn_layer, shortcut

# depth → (block counts, cardinality, base group width, SE reduction)
DEPTH_CFG = {
    50: ([3, 4, 6, 3], 32, 4, 16),
    101: ([3, 4, 23, 3], 32, 4, 16),
    152: ([3, 8, 36, 3], 64, 4, 16),
}


def squeeze_excitation(input, num_channels, reduction_ratio, name):
    """SE gate: global avg pool → FC(C/r, relu) → FC(C, sigmoid) →
    scale."""
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(
        pool, size=max(num_channels // reduction_ratio, 1), act="relu",
        param_attr=ParamAttr(name=name + "_sqz_weights"),
        bias_attr=ParamAttr(name=name + "_sqz_offset"))
    excitation = layers.fc(
        squeeze, size=num_channels, act="sigmoid",
        param_attr=ParamAttr(name=name + "_exc_weights"),
        bias_attr=ParamAttr(name=name + "_exc_offset"))
    # [N, C] → [N, C, 1, 1]; trailing-dim broadcast scales every pixel
    scale = layers.reshape(excitation, shape=[-1, num_channels, 1, 1])
    return layers.elementwise_mul(input, scale)


def se_bottleneck_block(input, num_filters, stride, cardinality,
                        reduction_ratio, name, is_test=False):
    """1x1 reduce → 3x3 grouped (cardinality) → 1x1 expand → SE →
    add."""
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name + "_conv1", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu",
                          name=name + "_conv2", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          name=name + "_conv3", is_test=is_test)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio,
                                name=name + "_se")
    short = shortcut(input, num_filters * 2, stride,
                     name=name + "_shortcut", is_test=is_test)
    return layers.relu(layers.elementwise_add(short, scaled))


def se_resnext(input, class_dim=1000, depth=50, is_test=False,
               prefix="se_resnext", cfg=None):
    """Build the tower; returns the softmax prediction variable.

    cfg overrides DEPTH_CFG[depth] — (counts, cardinality, group_width,
    reduction) — so tests can run a scaled-down net through the exact same
    code path."""
    counts, cardinality, group_width, reduction = cfg or DEPTH_CFG[depth]
    # stage base widths follow cardinality * group_width scaling
    base = cardinality * group_width
    num_filters = [base, base * 2, base * 4, base * 8]

    conv = conv_bn_layer(input, base // 2, 7, stride=2, act="relu",
                         name=prefix + "_conv1", is_test=is_test)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for stage, count in enumerate(counts):
        for blk in range(count):
            stride = 2 if blk == 0 and stage != 0 else 1
            suffix = chr(97 + blk) if blk < 26 else f"b{blk}"
            conv = se_bottleneck_block(
                conv, num_filters[stage], stride, cardinality, reduction,
                name=f"{prefix}{stage + 2}{suffix}", is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2, is_test=is_test)
    return layers.fc(drop, size=class_dim, act="softmax",
                     param_attr=ParamAttr(name=prefix + "_fc_weights"),
                     bias_attr=ParamAttr(name=prefix + "_fc_offset"))


def build_se_resnext(depth=50, class_dim=1000, image_shape=(3, 224, 224),
                     is_test=False, cfg=None):
    """Full training graph: data, tower, loss, accuracy.

    Returns (feed_names, prediction, avg_loss, acc)."""
    img = fluid.data(name="img", shape=[-1] + list(image_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    prediction = se_resnext(img, class_dim=class_dim, depth=depth,
                            is_test=is_test, cfg=cfg)
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, avg_loss, acc
