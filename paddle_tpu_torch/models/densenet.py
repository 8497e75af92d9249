"""DenseNet for image classification, Fluid graph-building style
(counterpart of ``paddle_tpu/models/densenet.py``).

Reference analog: the concat op family (operators/concat_op.cc) +
conv/bn: every layer consumes the channel concat of all previous
features in its block; the 1x1 bottleneck convs carry the FLOPs.
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers

# depth → dense-block layer counts (the classic 121/169/201 configs)
DEPTH_CFG = {
    121: (6, 12, 24, 16),
    169: (6, 12, 32, 32),
    201: (6, 12, 48, 32),
}


def _bn_relu_conv(x, num_filters, filter_size, padding=0, is_test=False):
    """DenseNet's pre-activation ordering: BN → ReLU → conv."""
    x = layers.batch_norm(x, act="relu", is_test=is_test)
    return layers.conv2d(x, num_filters=num_filters,
                         filter_size=filter_size, padding=padding,
                         bias_attr=False)


def dense_layer(x, growth_rate, is_test=False):
    """1x1 bottleneck (4k) → 3x3 producing growth_rate channels,
    concatenated onto the running feature stack."""
    new = _bn_relu_conv(x, 4 * growth_rate, 1, is_test=is_test)
    new = _bn_relu_conv(new, growth_rate, 3, padding=1, is_test=is_test)
    return layers.concat([x, new], axis=1)


def dense_block(x, num_layers, growth_rate, is_test=False):
    for _ in range(num_layers):
        x = dense_layer(x, growth_rate, is_test=is_test)
    return x


def transition(x, compression=0.5, is_test=False):
    """1x1 conv halving channels (compression) + 2x2 average pool."""
    out_ch = max(1, int(x.shape[1] * compression))
    x = _bn_relu_conv(x, out_ch, 1, is_test=is_test)
    return layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="avg")


def densenet(input, class_dim=1000, depth=121, growth_rate=32,
             is_test=False, block_cfg=None, compression=0.5):
    """Build the tower; returns the softmax prediction variable.

    block_cfg overrides DEPTH_CFG[depth] (a tuple of per-block layer
    counts) so tests can run a scaled-down net through the same path."""
    cfg = block_cfg or DEPTH_CFG[depth]
    tower = layers.conv2d(input, num_filters=2 * growth_rate,
                          filter_size=7, stride=2, padding=3,
                          bias_attr=False)
    tower = layers.batch_norm(tower, act="relu", is_test=is_test)
    tower = layers.pool2d(tower, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max")
    for i, num_layers in enumerate(cfg):
        tower = dense_block(tower, num_layers, growth_rate,
                            is_test=is_test)
        if i != len(cfg) - 1:
            tower = transition(tower, compression=compression,
                               is_test=is_test)
    tower = layers.batch_norm(tower, act="relu", is_test=is_test)
    pool = layers.pool2d(tower, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build_densenet(depth=121, class_dim=1000, image_shape=(3, 224, 224),
                   growth_rate=32, is_test=False, block_cfg=None):
    """Full training graph: data, tower, loss, accuracy.

    Returns (feed_names, prediction, avg_loss, acc)."""
    img = fluid.data(name="img", shape=[-1] + list(image_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    prediction = densenet(img, class_dim=class_dim, depth=depth,
                          growth_rate=growth_rate, is_test=is_test,
                          block_cfg=block_cfg)
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, loss, acc
