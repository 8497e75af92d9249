"""VGG for image classification, Fluid graph-building style
(counterpart of ``paddle_tpu/models/vgg.py``).

Reference analog: the vgg16_bn network the reference's book workload
trains (python/paddle/fluid/tests/book/test_image_classification.py):
stacked conv groups with batch norm, built on fluid.nets.img_conv_group.
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers

# depth → conv filters per group (pool after each group); the classic
# configs A/D/E with batch norm
DEPTH_CFG = {
    11: ([64], [128], [256, 256], [512, 512], [512, 512]),
    16: ([64, 64], [128, 128], [256, 256, 256], [512, 512, 512],
         [512, 512, 512]),
    19: ([64, 64], [128, 128], [256, 256, 256, 256], [512, 512, 512, 512],
         [512, 512, 512, 512]),
}


def vgg(input, class_dim=1000, depth=16, is_test=False, fc_dim=4096,
        groups=None, dropout=0.5):
    """Build the tower; returns the softmax prediction variable.

    groups overrides DEPTH_CFG[depth] (a tuple of per-group filter lists)
    so tests can run a scaled-down net through the same code path."""
    conv = input
    for filters in (groups or DEPTH_CFG[depth]):
        conv = fluid.nets.img_conv_group(
            conv, conv_num_filter=list(filters), pool_size=2,
            conv_padding=1, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True, conv_batchnorm_drop_rate=0.0,
            pool_stride=2, pool_type="max", is_test=is_test)
    flat = layers.flatten(conv, axis=1)
    fc1 = layers.fc(flat, size=fc_dim, act="relu")
    if dropout:
        fc1 = layers.dropout(fc1, dropout_prob=dropout, is_test=is_test)
    fc2 = layers.fc(fc1, size=fc_dim, act="relu")
    if dropout:
        fc2 = layers.dropout(fc2, dropout_prob=dropout, is_test=is_test)
    return layers.fc(fc2, size=class_dim, act="softmax")


def build_vgg(depth=16, class_dim=1000, image_shape=(3, 224, 224),
              is_test=False, fc_dim=4096, groups=None):
    """Full training graph: data, tower, loss, accuracy.

    Returns (feed_names, prediction, avg_loss, acc)."""
    img = fluid.data(name="img", shape=[-1] + list(image_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    prediction = vgg(img, class_dim=class_dim, depth=depth,
                     is_test=is_test, fc_dim=fc_dim, groups=groups)
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, loss, acc
