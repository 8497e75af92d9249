"""imikolov-shaped synthetic n-gram language-model dataset
(reference python/paddle/dataset/imikolov.py — PTB n-grams for word2vec).

build_dict() → {word: id}; train(word_idx, n) yields n-tuples of word ids
generated by a deterministic order-1 Markov chain, so an n-gram model has
real structure to learn.
"""

from __future__ import annotations

import numpy as np

from . import common

_VOCAB = 256
_TRAIN_TOKENS = 20000
_TEST_TOKENS = 4000


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(_VOCAB)}


def _chain(n_tokens, seed):
    r = common.rng(seed)
    # sparse random transition matrix: each word strongly prefers 4 successors
    succ = r.randint(0, _VOCAB, (_VOCAB, 4))
    toks = np.empty(n_tokens, dtype="int64")
    w = 0
    for i in range(n_tokens):
        toks[i] = w
        w = int(succ[w, r.randint(0, 4)])
    return toks


def _ngrams(tokens, n):
    return [tuple(int(t) for t in tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def train(word_idx, n):
    return common.make_reader(_ngrams(_chain(_TRAIN_TOKENS, seed=21), n))


def test(word_idx, n):
    return common.make_reader(_ngrams(_chain(_TEST_TOKENS, seed=22), n))
