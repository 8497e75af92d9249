"""IMDB-shaped synthetic sentiment dataset
(reference python/paddle/dataset/imdb.py — understand_sentiment book test).

Samples: (word_ids[list], label in {0,1}).  Each class draws words from a
biased region of the vocab, so bag-of-words models separate the classes.
"""

from __future__ import annotations

import numpy as np

from . import common

_VOCAB = 1024


def word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _make(n, seed):
    r = common.rng(seed)
    out = []
    for _ in range(n):
        label = int(r.randint(0, 2))
        L = int(r.randint(8, 40))
        center = _VOCAB // 4 if label == 0 else 3 * _VOCAB // 4
        ids = np.clip(r.normal(center, _VOCAB // 8, L), 0, _VOCAB - 1).astype("int64")
        out.append((ids.tolist(), label))
    return out


def train(word_idx=None):
    return common.make_reader(_make(2048, seed=71))


def test(word_idx=None):
    return common.make_reader(_make(512, seed=72))
