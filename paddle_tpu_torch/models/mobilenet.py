"""MobileNet-v1 for image classification, Fluid graph-building style
(counterpart of ``paddle_tpu/models/mobilenet.py``).

Reference analogs: the depthwise_conv2d op the reference registers in
paddle/fluid/operators/conv_op.cc and the MobileNet-SSD backbone of its
detection tests.  Each block is a depthwise 3x3 conv (the
``depthwise_conv2d`` op, bandwidth-bound) and a pointwise 1x1 conv, which
carries the FLOPs.
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers

# (num_filters, stride) per depthwise-separable block after the stem;
# the classic 30-layer v1 schedule
V1_CFG = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
)


def conv_bn(input, num_filters, filter_size, stride, padding, num_groups=1,
            act="relu", is_test=False, use_cudnn=True):
    """conv + BN + activation; a fully-grouped conv with use_cudnn=False
    emits the depthwise_conv2d op, exactly as era MobileNet code did."""
    conv = layers.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding, groups=num_groups, act=None,
        bias_attr=False, use_cudnn=use_cudnn)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def depthwise_separable(input, num_filters, stride, scale=1.0,
                        is_test=False):
    """depthwise 3x3 + pointwise 1x1 — MobileNet's defining block."""
    channels = input.shape[1]
    dw = conv_bn(input, num_filters=channels, filter_size=3, stride=stride,
                 padding=1, num_groups=channels, is_test=is_test,
                 use_cudnn=False)
    return conv_bn(dw, num_filters=max(1, int(num_filters * scale)),
                   filter_size=1, stride=1, padding=0, is_test=is_test)


def mobilenet(input, class_dim=1000, scale=1.0, is_test=False, cfg=None):
    """Build the tower; returns the softmax prediction variable.

    scale is the width multiplier; cfg overrides V1_CFG so tests can run a
    scaled-down net through the same code path."""
    tower = conv_bn(input, num_filters=max(1, int(32 * scale)),
                    filter_size=3, stride=2, padding=1, is_test=is_test)
    for num_filters, stride in (cfg or V1_CFG):
        tower = depthwise_separable(tower, num_filters, stride, scale=scale,
                                    is_test=is_test)
    pool = layers.pool2d(tower, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build_mobilenet(class_dim=1000, image_shape=(3, 224, 224), scale=1.0,
                    is_test=False, cfg=None):
    """Full training graph: data, tower, loss, accuracy.

    Returns (feed_names, prediction, avg_loss, acc)."""
    img = fluid.data(name="img", shape=[-1] + list(image_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    prediction = mobilenet(img, class_dim=class_dim, scale=scale,
                           is_test=is_test, cfg=cfg)
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, loss, acc
