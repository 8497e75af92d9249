"""MNIST-shaped synthetic dataset (reference python/paddle/dataset/mnist.py).

Samples: (image: float32[784] in [-1,1], label: int64 in [0,10)).
"""

from __future__ import annotations

import numpy as np

from . import common

TRAIN_N = 2048
TEST_N = 512


def _make(n, seed):
    feats, labels = common.class_blobs(n, 10, 784, seed, spread=0.5, noise=0.3)
    feats = np.tanh(feats)  # squash into [-1, 1] like normalized pixels
    return [(feats[i], int(labels[i])) for i in range(n)]


def train():
    return common.make_reader(_make(TRAIN_N, seed=42))


def test():
    return common.make_reader(_make(TEST_N, seed=43))
