"""MNIST and regression models (counterpart of
``paddle_tpu/models/mlp.py``; reference tests/book/
test_recognize_digits.py:45-76 and test_fit_a_line.py:27-44).
"""

from __future__ import annotations

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers


def build_mlp(img_shape=(1, 28, 28), num_classes=10, hidden=(200, 200)):
    """book/02 multilayer_perceptron: img -> fc(relu)*2 -> fc(softmax).

    Returns (feeds, prediction, avg_loss, acc).
    """
    img = fluid.data(name="img", shape=[-1] + list(img_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    x = img
    for i, h in enumerate(hidden):
        x = layers.fc(x, size=h, act="relu")
    prediction = layers.fc(x, size=num_classes, act="softmax")
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, avg_loss, acc


def build_conv_net(img_shape=(1, 28, 28), num_classes=10):
    """book/02 convolutional_neural_network: two conv+pool(+bn) stages."""
    from paddle_tpu_torch.fluid import nets

    img = fluid.data(name="img", shape=[-1] + list(img_shape),
                     append_batch_size=False, dtype="float32")
    label = fluid.data(name="label", shape=[-1, 1],
                       append_batch_size=False, dtype="int64")
    conv1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    bn1 = layers.batch_norm(conv1)
    conv2 = nets.simple_img_conv_pool(
        input=bn1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    prediction = layers.fc(conv2, size=num_classes, act="softmax")
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return ["img", "label"], prediction, avg_loss, acc


def build_fit_a_line(dim=13):
    """book/01 fit_a_line: linear regression (test_fit_a_line.py:27-44)."""
    x = fluid.data(name="x", shape=[-1, dim],
                   append_batch_size=False, dtype="float32")
    y = fluid.data(name="y", shape=[-1, 1],
                   append_batch_size=False, dtype="float32")
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    return ["x", "y"], y_predict, avg_cost
