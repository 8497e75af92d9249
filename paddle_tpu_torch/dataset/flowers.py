"""Flowers-102-shaped synthetic dataset (reference
python/paddle/dataset/flowers.py).

Samples: (image: float32[3*224*224] in [0,1], label: int64 in [0,102)).
Images are class-colored gradients + noise so a small conv net separates
classes; kept at 102 classes / 224px shapes for API parity."""

from __future__ import annotations

import numpy as np

from . import common

N_CLASSES = 102
_DIM = 3 * 224 * 224


def _make(n, seed):
    r = common.rng(seed)
    out = []
    for _ in range(n):
        label = int(r.randint(0, N_CLASSES))
        # class-specific mean color per channel + smooth noise
        base = (np.asarray([label % 7, (label // 7) % 5, (label // 35) % 3],
                           dtype="float32")
                / np.asarray([7, 5, 3], dtype="float32"))
        img = np.repeat(base, _DIM // 3).astype("float32")
        img += 0.08 * r.randn(_DIM).astype("float32")
        out.append((np.clip(img, 0.0, 1.0), label))
    return out


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return common.make_reader(_make(256, seed=80))


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return common.make_reader(_make(64, seed=81))


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return common.make_reader(_make(64, seed=82))
