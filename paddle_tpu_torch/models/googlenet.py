"""GoogLeNet (Inception-v1) for image classification, Fluid style
(counterpart of ``paddle_tpu/models/googlenet.py``).

Reference analog: the concat-of-parallel-branches pattern the
reference's op set serves (operators/concat_op.cc + conv/pool): four
independent conv branches concatenated on the channel axis.  Its max
pools use ``ceil_mode``.
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers

# per-stage inception configs: (c1x1, c3x3r, c3x3, c5x5r, c5x5, proj)
V1_CFG = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _conv(input, num_filters, filter_size, stride=1, padding=0):
    return layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act="relu")


def inception(input, c1x1, c3x3r, c3x3, c5x5r, c5x5, proj):
    """The four parallel branches, concatenated on the channel axis."""
    b1 = _conv(input, c1x1, 1)
    b2 = _conv(_conv(input, c3x3r, 1), c3x3, 3, padding=1)
    b3 = _conv(_conv(input, c5x5r, 1), c5x5, 5, padding=2)
    pool = layers.pool2d(input, pool_size=3, pool_stride=1, pool_padding=1,
                         pool_type="max")
    b4 = _conv(pool, proj, 1)
    return layers.concat([b1, b2, b3, b4], axis=1)


def _aux_head(input, class_dim, is_test, dropout=0.7):
    """Training-time auxiliary classifier (inception 4a/4d taps)."""
    pool = layers.pool2d(input, pool_size=5, pool_stride=3, pool_type="avg")
    conv = _conv(pool, 128, 1)
    fc1 = layers.fc(layers.flatten(conv, axis=1), size=1024, act="relu")
    drop = layers.dropout(fc1, dropout_prob=dropout, is_test=is_test)
    return layers.fc(drop, size=class_dim, act="softmax")


def googlenet(input, class_dim=1000, is_test=False, cfg=None,
              with_aux=True, stem_filters=(64, 64, 192), dropout=0.4):
    """Build the tower; returns (prediction, aux1, aux2) — the aux heads
    are None when with_aux=False or in test mode.

    cfg overrides V1_CFG (a dict of per-stage 6-tuples; stages named like
    "3a" — the digit places the pool boundaries) so tests can run a
    scaled-down net through the same code path."""
    cfg = cfg or V1_CFG
    s1, s2, s3 = stem_filters
    tower = _conv(input, s1, 7, stride=2, padding=3)
    tower = layers.pool2d(tower, pool_size=3, pool_stride=2,
                          pool_type="max", ceil_mode=True)
    tower = _conv(_conv(tower, s2, 1), s3, 3, padding=1)
    tower = layers.pool2d(tower, pool_size=3, pool_stride=2,
                          pool_type="max", ceil_mode=True)
    aux1 = aux2 = None
    stage = None
    for name in sorted(cfg):
        if stage is not None and name[0] != stage:
            tower = layers.pool2d(tower, pool_size=3, pool_stride=2,
                                  pool_type="max", ceil_mode=True)
        stage = name[0]
        tower = inception(tower, *cfg[name])
        if with_aux and not is_test:
            if name == "4a":
                aux1 = _aux_head(tower, class_dim, is_test)
            elif name == "4d":
                aux2 = _aux_head(tower, class_dim, is_test)
    pool = layers.pool2d(tower, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=dropout, is_test=is_test)
    prediction = layers.fc(drop, size=class_dim, act="softmax")
    return prediction, aux1, aux2


def build_googlenet(class_dim=1000, image_shape=(3, 224, 224),
                    is_test=False, cfg=None, with_aux=True):
    """Full training graph: data, tower, loss (main + 0.3x each aux head,
    the paper's weighting), accuracy.

    Returns (feed_names, prediction, avg_loss, acc)."""
    img = fluid.data(name="img", shape=[-1] + list(image_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    prediction, aux1, aux2 = googlenet(img, class_dim=class_dim,
                                       is_test=is_test, cfg=cfg,
                                       with_aux=with_aux)
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    for aux in (aux1, aux2):
        if aux is not None:
            aux_loss = layers.mean(layers.cross_entropy(input=aux,
                                                        label=label))
            loss = loss + 0.3 * aux_loss
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, loss, acc
